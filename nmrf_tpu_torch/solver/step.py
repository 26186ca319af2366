"""One training step (``nmrf_tpu/parallel/mesh.py:make_train_step``):
forward in train mode, criterion, backward, gradient clip and an AdamW
update with the schedule, with ``SOLVER.ACCUM_STEPS`` micro-batches per
update as ``optax.MultiSteps`` takes them; on one device, or over a
(data, spatial) process grid."""

import torch

from ..parallel.mesh import spatial_sharded_apply, sum_gradients


def make_train_step(model, criterion, optimizer, scheduler, accum_steps=1, *,
                    grad_clip, mesh=None):
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
    """
    params = [p for group in optimizer.param_groups for p in group["params"]]
    micro = 0

    def step(batch):
        nonlocal micro
        model.train()
        if mesh is None:
            out = model(batch["img1"], batch["img2"])
        else:
            out = spatial_sharded_apply(model, mesh, batch["img1"],
                                        batch["img2"])
        losses = criterion(out, {"disp": batch["disp"],
                                 "valid": batch["valid"]})
        (losses["total"] / accum_steps).backward()
        micro += 1
        result = {k: v.detach().float() for k, v in losses.items()}
        if micro == accum_steps:
            if mesh is not None:
                sum_gradients(params, mesh)
            result["grad_norm"] = torch.nn.utils.clip_grad_norm_(
                params, grad_clip).detach().float()
            optimizer.step()
            scheduler.step()
            optimizer.zero_grad(set_to_none=True)
            micro = 0
        return result

    return step
