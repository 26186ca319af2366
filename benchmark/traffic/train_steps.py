"""Traffic generator: training steps through the step that
``nmrf_tpu_torch.solver.make_train_step`` returns (forward, criterion,
backward, gradient clip, AdamW and the schedule), with the optimizer of
``build_optimizer`` and the criterion of ``build_criterion``.

Set-up makes the weights from the seed with the plain reference on the
card and loads them into the measured model, makes a host pool of
batches from the seed, and builds the one step object that the window
then drives.  Its first ``checked_steps`` steps, on batches whose pairs
all differ, are the warm-up and the checked steps: their losses are
kept, the first gradient as the optimizer took it (AdamW's first moment
after one step, over 1 - beta1), and the parameters after them.  The
window runs steps on the pool's batches, each copied to the card as the
step takes it, for the given seconds, and ends on a loss readback.  The
check runs the float32 reference step from the same weights on the same
batches (for the swin variant also the same drop-path masks: one
generator on the card seeded as the configuration's ``SEED``, drawn in
forward order) and compares (``train_numbers``).  The reference takes
the program's integer choices of each checked step from outputs that
hooks keep during those steps: the seeds the NMS picks from the DPN's
probabilities, and the positions (each pixel's candidate of the largest
score, the median of each 4 x 4 block) that give the Refinement its
input.  With random weights the DPN's probabilities are nearly flat, and
a choice made on them flips between bf16 and float32 on most pixels.
The reference's own code makes each choice from the program's outputs
(``reference.choices``), so a wrong choice still shows, and every value
it then computes, the Refinement's input among them, is its own."""

import statistics
import time

import numpy as np
import torch

from benchmark import arith, frames, harness, reference
from benchmark.reference import train as rtrain

BETA1 = 0.9  # AdamW's first-moment decay in the recipe


def norms(leaves):
    return {n: float(t.float().norm()) for n, t in leaves.items()}


def leaf_gaps(prog, ref, keep=None):
    """Each leaf's |norm of prog - norm of ref| over the larger of the
    reference's norm of that leaf and of the median leaf: (the worst, the
    median, the worst leaf's name)."""
    names = [n for n in ref if keep is None or n in keep]
    median = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], median) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], statistics.median(gaps.values()), worst


def train_numbers(prog, ref, p0):
    """The compared numbers: ``prog`` and ``ref`` dicts of ``loss`` (each
    checked step's), ``grad`` (the first step's clipped gradient by
    parameter name) and ``params`` (after the checked steps); ``p0`` the
    initial parameters.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone under Adam:
    they are left out of the change."""
    gp, gr = norms(prog["grad"]), norms(ref["grad"])
    floor = 1e-3 * statistics.median(gr.values())
    moved = {n for n, v in gr.items() if v >= floor}
    dp = norms({n: prog["params"][n] - p0[n] for n in p0})
    dr = norms({n: ref["params"][n] - p0[n] for n in p0})
    grad, grad_median, g_leaf = leaf_gaps(gp, gr)
    change, change_median, c_leaf = leaf_gaps(dp, dr, moved)
    harness.log(f"worst leaves: gradient {g_leaf}, change {c_leaf}")
    return {
        "loss_rel": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": grad, "grad_gap_median": grad_median,
        "change_gap": change, "change_gap_median": change_median,
    }


class _AllKept:
    """Drop-path masks that keep every sample, on the meta device."""

    @staticmethod
    def draw(batch, keep):
        return torch.ones(batch, dtype=torch.bool, device="meta")


class Generator:
    def __init__(self, cell, seed, device, trace=False):
        self.cell, self.seed, self.device = cell, seed, device
        self.p = cell.traffic
        self.spec = cell.spec("training")
        self.trace_on = trace
        self.calls = harness.Calls()

    # ---- set-up ----------------------------------------------------------

    def weights(self):
        ref = reference.build(self.spec, self.device)
        return reference.init_weights(ref, self.seed)

    def inputs(self):
        """The pool: host batches, pinned on a card, from the seed."""
        p = self.p
        gen = frames.rng(self.seed, 0)
        pool = []
        for _ in range(p["pool"]):
            pairs = [frames.stereo_pair(gen, p["height"], p["width"],
                                        p["max_disp"])
                     for _ in range(p["batch"])]
            left, right, disp, valid = (torch.from_numpy(np.stack(x))
                                        for x in zip(*pairs))
            batch = {"img1": left.float(), "img2": right.float(),
                     "disp": disp, "valid": valid}
            if self.device.type == "cuda":
                batch = {k: v.pin_memory() for k, v in batch.items()}
            pool.append(batch)
        self.pool = pool

    def feed(self, batch):
        return {k: v.to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def setup(self):
        from nmrf_tpu_torch.models import build_criterion, build_model
        from nmrf_tpu_torch.solver import build_optimizer, make_train_step

        cfg = harness.port_cfg(self.spec, self.seed)
        ref = self.weights()
        self.model = build_model(cfg, device=self.device)
        self.model.load_state_dict(ref.state_dict())
        del ref
        harness.free(self.device)
        self.optimizer, scheduler = build_optimizer(self.model, cfg)
        self.step = make_train_step(self.model, build_criterion(cfg),
                                    self.optimizer, scheduler,
                                    cfg.SOLVER.ACCUM_STEPS,
                                    grad_clip=cfg.SOLVER.GRAD_CLIP)
        self.inputs()
        if self.trace_on:
            harness.install_probes(self.model, self.calls)
        names = {id(p): n for n, p in self.model.named_parameters()}
        kept = {}
        hooks = [self.model.register_forward_hook(
                     lambda m, a, o: kept.update(out=o)),
                 self.model.infer_head.register_forward_hook(
                     lambda m, a, o: kept.update(head=o[-1])),
                 self.model.infer_score_head.register_forward_hook(
                     lambda m, a, o: kept.update(score=o[-1]))]
        losses, grad, made = [], None, []
        for i in range(self.p["checked_steps"]):
            losses.append(self.step(self.feed(self.pool[i]))["total"])
            made.append({"prob": kept["out"]["prob"].detach().cpu(),
                         "proposal": kept["out"]["proposal"].detach().cpu(),
                         "heads": (kept["head"].detach().cpu(),
                                   kept["score"].detach().cpu())})
            kept.clear()
            if grad is None:
                grad = {names[id(p)]: (s["exp_avg"] / (1.0 - BETA1)).cpu()
                        for p, s in self.optimizer.state.items()}
        for h in hooks:
            h.remove()
        self.prog = {"loss": [float(v) for v in losses], "grad": grad,
                     "made": made,
                     "params": {n: p.detach().cpu().clone()
                                for n, p in self.model.named_parameters()}}
        self.n = self.p["checked_steps"]

    # ---- the window -----------------------------------------------------

    def run_steps(self, count=None, seconds=None):
        """Steps on the pool's batches in turn, ``count`` of them or for
        ``seconds`` of host time; ends on a loss readback.  Returns (steps,
        the window's seconds)."""
        done, self.marks = 0, []
        with arith.Window(self.device) as w:
            t0 = time.perf_counter()
            while (done < count) if count is not None \
                    else (time.perf_counter() - t0 < seconds):
                losses = self.step(self.feed(
                    self.pool[self.n % len(self.pool)]))
                self.n += 1
                done += 1
                self.marks.append(time.perf_counter() - t0)
            float(losses["total"])
        return done, w.wall_ms / 1e3

    def timeline(self):
        """The host's ms between the ends of the window's step calls (when
        a step's launches had been issued): the median, the 90th
        percentile and the longest."""
        gaps = np.diff([0.0] + self.marks) * 1e3
        return [round(float(x), 1) for x in
                (np.median(gaps), np.percentile(gaps, 90), gaps.max())]

    def measure(self, seconds):
        steps, window = self.run_steps(seconds=seconds)
        harness.log("window: host ms between step calls, median, 90th "
                    f"percentile, longest {self.timeline()}")
        return {"steps": steps, "window_s": window,
                "pairs": steps * self.p["batch"], "attempted": steps,
                "failed": 0}

    def trace(self, path):
        n = self.p["trace_steps"]
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.calls.on = True
        harness.profiled(lambda: self.run_steps(count=n), self.device, path)
        self.calls.on = False
        peak = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == "cuda" else 0
        return {"trace": arith.Trace(path), "traced_steps": n,
                "attn_calls": list(self.calls), "peak_bytes": peak,
                "flops_per_unit": self.flops()}

    def flops(self):
        """FLOPs of one step's forward, loss and backward, counted on the
        reference on the meta device at the step's batch and crop."""
        from torch.utils.flop_counter import FlopCounterMode

        p = self.p
        model = reference.build(self.spec, "meta").train()
        model.set_drop_path_masks(_AllKept())
        shape = (p["batch"], p["height"], p["width"])
        x = torch.zeros(*shape, 3, device="meta")
        disp = torch.zeros(shape, device="meta")
        valid = torch.ones(shape, dtype=torch.bool, device="meta")
        with FlopCounterMode(display=False) as counter:
            rtrain.Criterion(self.spec)(model(x, x), disp, valid).backward()
        return counter.get_total_flops()

    # ---- the output check -----------------------------------------------

    def reference_run(self, fp8=False, rows=None, force=None):
        """The reference's checked steps from the seed's weights: (its
        ``loss``, ``grad``, ``force`` and ``params``, the initial
        parameters), float32 (or the control: its float8 form; ``rows``:
        each batch's first rows only), its discrete choices taken from
        ``force`` where given."""
        with harness.strict_f32():
            model = self.weights().set_remat()
            p0 = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
            if fp8:
                reference.set_fp8(model)
            model.set_drop_path_masks(reference.DropPathMasks(torch.Generator(
                device=self.device).manual_seed(max(int(self.seed), 0))))
            opt, sched = rtrain.optimizer(model, self.spec)
            batches = [{k: v[:rows].to(self.device) for k, v in b.items()}
                       for b in self.pool[:self.p["checked_steps"]]]
            out = rtrain.train_steps(model, rtrain.Criterion(self.spec),
                                     opt, sched, batches,
                                     self.spec["SOLVER.GRAD_CLIP"], force)
            out["grad"] = {n: g.cpu() for n, g in out["grad"].items()}
            out["params"] = {n: p.detach().cpu()
                             for n, p in model.named_parameters()}
            del model, opt, batches
            harness.free(self.device)
            return out, p0

    def check(self):
        del self.model, self.step, self.optimizer
        harness.free(self.device)
        force = [reference.choices(m) for m in self.prog.pop("made")]
        ref, p0 = self.reference_run(force=force)
        harness.log(f"losses program {self.prog['loss']} reference "
                    f"{ref['loss']}")
        return train_numbers(self.prog, ref, p0)

    def control(self):
        """The control's numbers: the float8 reference in the program's
        place."""
        low, p0 = self.reference_run(fp8=True)
        ref, _ = self.reference_run(force=low["force"])
        return train_numbers(low, ref, p0)

    def fault(self, name):
        """A fault's numbers, planted in the reference put in the
        program's place: ``half_batch`` (each step on the first half of
        its batch, the mean over those)."""
        if name != "half_batch":
            raise ValueError(f"no fault {name!r}")
        bad, p0 = self.reference_run(rows=self.p["batch"] // 2)
        ref, _ = self.reference_run(force=bad["force"])
        return train_numbers(bad, ref, p0)
