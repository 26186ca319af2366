"""One training step (``nmrf_tpu/parallel/mesh.py:make_train_step``):
forward in train mode, criterion, backward, gradient clip and an AdamW
update with the schedule, with ``SOLVER.ACCUM_STEPS`` micro-batches per
update as ``optax.MultiSteps`` takes them; on one device, or over a
(data, spatial) process grid.  The step's parts run inside the profiler
ranges ``nmrf::forward``, ``nmrf::loss``, ``nmrf::backward`` and
``nmrf::optimizer`` (``tools/profile_train.py`` splits a trace by them)."""

import torch
from torch.profiler import record_function

from ..models.adaptor import MSDeformAttn
from ..parallel.mesh import spatial_sharded_apply, sum_gradients


def make_train_step(model, criterion, optimizer, scheduler, accum_steps=1, *,
                    grad_clip, mesh=None, monitor_oob=False):
    """Returns ``step(batch) -> losses``.

    batch: dict of tensors on the model's device, ``img1``/``img2``
    [B, H, W, 3] float (0..255), ``disp`` [B, H, W] float, ``valid``
    [B, H, W] bool.  losses: dict of detached float32 scalars, with
    ``total`` and ``epe_train``; after an update it also holds
    ``grad_norm``, the global gradient norm before clipping.

    Gradients are averaged over ``accum_steps`` calls; every
    ``accum_steps``-th call clips them to ``grad_clip`` (the config's
    ``SOLVER.GRAD_CLIP``; it has no default), updates the
    parameters and advances the schedule, so the other calls leave the
    parameters as they are.

    mesh: a ``parallel.make_mesh`` grid, the model built with it.  The batch
    is then this rank's part (``parallel.shard_batch``: its data index's
    images, the targets whole).  The forward runs H-sharded
    (``spatial_sharded_apply``), its outputs are gathered into the global
    layouts, and every rank computes the one global loss of the JAX step;
    before the clip the gradients are summed over the world
    (``parallel.sum_gradients`` says why a sum), so every rank applies the
    same update.

    monitor_oob: the swin variant's tap-path diagnostic
    (``nmrf_tpu/parallel/mesh.py:make_train_step``).  losses then also hold
    ``msda_tap_oob``, the largest share of samples beyond the tap radius
    over the neck's extractors, as its maximum over the interval since the
    last ``step.read_oob()``: a device scalar, with no host sync per step,
    so a spike between two readbacks is not lost.  With a data axis each
    extractor's share is the global batch's (its shards' mean, one
    all-reduce), so every rank holds the same value.  ``step.read_oob(guard=
    None)`` reads it back (one sync), starts a new interval and returns the
    float (None when no step reported one).  Given a
    ``utils.guards.TapOOBGuard`` it passes the value to ``guard.check``;
    when that requests the fallback, every ``MSDeformAttn`` of the model is
    switched in place to the exact gather path (tap radius 0) and the
    monitoring stops: on every rank of a mesh at once, since all read the
    same value.  In place, because the optimizer holds the parameter
    objects and their state: the step goes on with both as they are.

    ``step.state_dict()`` and ``step.load_state_dict(state)`` carry the
    accumulation state across a checkpoint (``optax.MultiSteps`` keeps it
    in the JAX package's optimizer state): the micro-step count since the
    last update and, between micro-steps, the gradients summed so far, one
    per optimizer parameter (None where a parameter has none).  On a mesh
    those are rank-local until the update sums them, so ``state_dict`` then
    saves their sum over the world (an all-reduce: every rank calls it) and
    ``load_state_dict`` gives that sum to rank 0 and zeros to the others,
    whose sum at the update is the same.
    """
    params = [p for group in optimizer.param_groups for p in group["params"]]
    attns = [m for m in model.modules() if isinstance(m, MSDeformAttn)]
    micro = 0
    oob = {"monitor": monitor_oob, "max": None}

    def forward(batch):
        if mesh is None:
            return model(batch["img1"], batch["img2"])
        return spatial_sharded_apply(model, mesh, batch["img1"], batch["img2"])

    def step(batch):
        nonlocal micro
        model.train()
        with record_function("nmrf::forward"):
            if oob["monitor"]:
                for m in attns:
                    m.monitor_oob, m.oob = True, None
                try:
                    out = forward(batch)
                finally:
                    for m in attns:
                        m.monitor_oob = False
                fracs = [m.oob for m in attns if m.oob is not None]
            else:
                out, fracs = forward(batch), []
        with record_function("nmrf::loss"):
            losses = criterion(out, {"disp": batch["disp"],
                                     "valid": batch["valid"]})
        with record_function("nmrf::backward"):
            (losses["total"] / accum_steps).backward()
        micro += 1
        result = {k: v.detach().float() for k, v in losses.items()}
        if fracs:
            frac = torch.cat(fracs)
            if mesh is not None and mesh.data > 1:
                # each rank's shares are means over its own images: their
                # mean over the world is that over the global batch (the
                # ranks of a spatial group hold one data shard's backbone
                # alike), taken before the maximum over layers and levels
                # as the JAX global step takes it; one all-reduce on the
                # device, no host sync
                frac = mesh.world.all_reduce(frac) / mesh.world.size
            frac = frac.max()
            if oob["max"] is not None:
                frac = torch.maximum(frac, oob["max"])
            oob["max"] = result["msda_tap_oob"] = frac
        if micro == accum_steps:
            with record_function("nmrf::optimizer"):
                if mesh is not None:
                    sum_gradients(params, mesh)
                result["grad_norm"] = torch.nn.utils.clip_grad_norm_(
                    params, grad_clip).detach().float()
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad(set_to_none=True)
            micro = 0
        return result

    def read_oob(guard=None):
        value = None if oob["max"] is None else float(oob["max"])
        oob["max"] = None
        if value is not None and guard is not None and guard.check(value):
            for m in attns:
                m.tap_radius = 0
            oob["monitor"] = False
        return value

    def state_dict():
        grads = None
        if micro:
            grads = [None if p.grad is None else p.grad.detach().clone()
                     for p in params]
            if mesh is not None:
                live = [g for g in grads if g is not None]
                total = mesh.world.all_reduce(
                    torch.cat([g.reshape(-1).float() for g in live]))
                offset = 0
                for g in live:
                    g.copy_(total[offset:offset + g.numel()].view_as(g))
                    offset += g.numel()
        return {"micro": micro, "grads": grads}

    def load_state_dict(state):
        nonlocal micro
        if not 0 <= state["micro"] < accum_steps:
            raise ValueError(f"micro-step {state['micro']} of a checkpoint "
                             f"does not fit accum_steps {accum_steps}")
        micro = state["micro"]
        grads = state["grads"] or [None] * len(params)
        if len(grads) != len(params):
            raise ValueError(f"{len(grads)} saved gradients for "
                             f"{len(params)} parameters")
        for p, g in zip(params, grads):
            if g is not None:
                g = g.to(p.device, p.dtype)
                if mesh is not None and mesh.rank != 0:
                    g = torch.zeros_like(g)
            p.grad = g

    step.read_oob = read_oob
    step.state_dict = state_dict
    step.load_state_dict = load_state_dict
    return step
