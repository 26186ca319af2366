"""Traffic generator: one client's closed loop of KITTI-size requests through
``nmrf_tpu_torch.inference.predict``, each request from the host's uint8
frame pair to the returned numpy disparity.

Set-up makes the weights from the seed with the plain reference on the
card and loads them into the measured model, makes the pool of frame
pairs from the seed and the order the client sends them in, and serves
``warmup`` requests.  The window serves one request after another for
the given seconds; each request's latency is the host clock around its
``predict`` call.  A sample of request indices, drawn from the seed
below ``sample_within``, keeps its outputs: the disparity returned, and
from hooks on the model the 1/8 features of both images, the DPN's
probabilities and proposals and the Inference and Refinement stages'
outputs, and the last Inference layer's two heads.  The check runs the
float32 reference on the same padded pairs and compares each of those
(``serve_numbers``).  The reference takes the program's integer choices
from the program's outputs: the seeds the NMS picks from the DPN's
probabilities, and the positions (each pixel's candidate of the largest
score, the median of each 4 x 4 block) that give the Refinement its
input.  With random weights the probabilities are nearly flat, and a
choice made on them flips between bf16 and float32 on most pixels.  The
reference's own code makes each choice from the program's outputs
(``reference.choices``), so a wrong choice still shows, and every value
it then computes, the heads and the Refinement's input among them, is
its own."""

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import arith, frames, harness, reference


def serve_numbers(prog, ref):
    """The compared numbers of one request: ``prog`` and ``ref`` dicts of
    host tensors (``features``, ``prob``, ``proposal``, ``inference``,
    ``heads``, ``refinement``, ``disp`` unpadded)."""
    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-12))

    return {
        "features_rel": rel(prog["features"], ref["features"]),
        "prob_l1": float((prog["prob"] - ref["prob"]).abs().sum(-1).mean()),
        "proposal_px": float(8.0 * (prog["proposal"] - ref["proposal"])
                             .abs().mean()),
        "inference_rel": rel(prog["inference"], ref["inference"]),
        "heads_rel": max(rel(a, b) for a, b in zip(prog["heads"],
                                                   ref["heads"])),
        "refinement_rel": rel(prog["refinement"], ref["refinement"]),
        "epe_px": float((prog["disp"] - ref["disp"]).abs().mean()),
    }


HOST_KEYS = ("features", "prob", "proposal", "inference", "refinement",
             "heads")


def host(out):
    """A forward's compared outputs, float32 on the host: the stage
    outputs of the one request, the rest whole."""
    out = dict(out)
    for key in ("inference", "refinement"):
        out[key] = out[key][0]
    return {k: tuple(t.float().cpu() for t in v) if isinstance(v, tuple)
            else v.float().cpu() for k, v in out.items()}


def worst(rows):
    """The largest of each number over the compared requests."""
    return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}


class Generator:
    def __init__(self, cell, seed, device, trace=False):
        self.cell, self.seed, self.device = cell, seed, device
        self.p = cell.traffic
        self.spec = cell.spec("serving")
        self.trace_on = trace
        self.calls = harness.Calls()

    # ---- set-up ----------------------------------------------------------

    def weights(self):
        ref = reference.build(self.spec, self.device)
        return reference.init_weights(ref, self.seed)

    def setup(self):
        from nmrf_tpu_torch.inference import predict
        from nmrf_tpu_torch.models import build_model

        self.predict = predict
        p = self.p
        ref = self.weights()
        self.model = build_model(harness.port_cfg(self.spec, self.seed),
                                 device=self.device)
        self.model.load_state_dict(ref.state_dict())
        del ref
        harness.free(self.device)
        self.inputs()
        self.kept, self.capture = {}, None
        self._hooks()
        if self.trace_on:
            harness.install_probes(self.model, self.calls)
        for i in range(p["warmup"]):
            self.predict(self.model, *self.pool[i % p["pool"]])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def inputs(self):
        """The pool of frame pairs, the order the client sends them in and
        the sampled request indices, all from the seed."""
        p = self.p
        gen = frames.rng(self.seed, 0)
        self.pool = [frames.stereo_pair(gen, p["height"], p["width"],
                                        p["max_disp"])[:2]
                     for _ in range(p["pool"])]
        self.order = frames.rng(self.seed, 1).permutation(p["pool"])
        self.sample = set(int(i) for i in frames.rng(self.seed, 2).choice(
            p["sample_within"], size=p["sample"], replace=False))

    def _hooks(self):
        m = self.model

        def keep(key, pick):
            def hook(module, args, out):
                if self.capture is not None:
                    self.capture[key] = pick(out)
            return hook

        m.backbone.register_forward_hook(keep("features", lambda o: o[1]))
        m.inference.register_forward_hook(keep("inference", lambda o: o[0]))
        m.infer_head.register_forward_hook(keep("head", lambda o: o[-1]))
        m.infer_score_head.register_forward_hook(keep("score",
                                                      lambda o: o[-1]))
        m.refinement.register_forward_hook(keep("refinement", lambda o: o[0]))
        m.register_forward_hook(keep("out", lambda o: (o["prob"],
                                                       o["proposal"])))

    # ---- the window -----------------------------------------------------

    def request(self, i):
        self.capture = {} if i in self.sample else None
        a, b = self.pool[self.order[i % len(self.order)]]
        disp = self.predict(self.model, a, b)
        if self.capture is not None:
            self.capture["disp"] = disp
            self.kept[i] = self.capture
        self.capture = None

    def measure(self, seconds):
        lat, i = [], 0
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            self.request(i)
            te = time.perf_counter()
            lat.append((te - ts) * 1e3)
            i += 1
            if te - t0 >= seconds:
                break
        self.done = i
        q = [arith.percentile(lat, p) for p in (0, 50, 95, 100)]
        harness.log(f"{i} requests in {te - t0:.3f} s; latency ms min "
                    f"{q[0]:.2f} p50 {q[1]:.2f} p95 {q[2]:.2f} max {q[3]:.2f}")
        return {"latencies_ms": lat, "window_s": te - t0, "completed": i,
                "attempted": i, "failed": 0}

    def trace(self, path):
        n = self.p["trace_requests"]
        start = self.done + 1000  # no sampled index: nothing kept

        def run():
            for j in range(n):
                with record_function("bench::request"):
                    self.request(start + j)

        self.calls.on = True
        harness.profiled(run, self.device, path)
        self.calls.on = False
        return {"trace": arith.Trace(path), "traced_frames": n,
                "attn_calls": list(self.calls), "flops_per_unit": self.flops()}

    def flops(self):
        """FLOPs of one request, counted on the reference on the meta
        device at the served padded size."""
        from torch.utils.flop_counter import FlopCounterMode

        model = reference.build(self.spec, "meta")
        H, W = frames.pad_to(np.zeros((self.p["height"], self.p["width"], 1),
                                      np.uint8),
                             self.spec["DATASETS.DIVIS_BY"]).shape[:2]
        x = torch.zeros(1, H, W, 3, device="meta")
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x, x)
        return counter.get_total_flops()

    # ---- the output check -----------------------------------------------

    def program_outputs(self):
        """The kept requests' outputs on the host, by request index."""
        out = {}
        for i, k in sorted(self.kept.items()):
            prob, proposal = k["out"]
            out[i] = host({"features": k["features"], "prob": prob,
                           "proposal": proposal, "inference": k["inference"],
                           "refinement": k["refinement"],
                           "heads": (k["head"], k["score"])})
            out[i]["disp"] = torch.from_numpy(np.asarray(k["disp"]))
        return out

    def reference_outputs(self, indices, fp8=False, force=None):
        """The reference's outputs on the requests ``indices``, float32
        (or the control: its float8 form), its integer choices taken from
        ``force`` (by request index, ``reference.choices``) where given."""
        with harness.strict_f32():
            model = self.weights()
            if fp8:
                reference.set_fp8(model)
            div = self.spec["DATASETS.DIVIS_BY"]
            H, W = self.p["height"], self.p["width"]
            out = {}
            with torch.no_grad():
                for i in indices:
                    a, b = self.pool[self.order[i % len(self.order)]]
                    x = [torch.from_numpy(frames.pad_to(f, div)[None].astype(
                        np.float32)).to(self.device) for f in (a, b)]
                    f = None if force is None else {
                        k: v.to(self.device) for k, v in force[i].items()}
                    o = model(*x, f)
                    out[i] = host({k: o[k] for k in HOST_KEYS})
                    out[i]["disp"] = o["disp"][0, :H, :W].float().cpu()
            del model
            harness.free(self.device)
            return out

    def check(self):
        prog = self.program_outputs()
        self.kept.clear()
        del self.model
        harness.free(self.device)
        ref = self.reference_outputs(
            sorted(prog), force={i: reference.choices(o)
                                 for i, o in prog.items()})
        numbers = worst([serve_numbers(prog[i], ref[i]) for i in prog])
        harness.log(f"compared {len(prog)} requests of {self.done}: "
                    f"{sorted(prog)}")
        return numbers

    def control(self):
        """The control's numbers: the float8 reference in the program's
        place on the sampled requests."""
        idx = sorted(self.sample)
        low = self.reference_outputs(idx, fp8=True)
        ref = self.reference_outputs(
            idx, force={i: reference.choices(o) for i, o in low.items()})
        return worst([serve_numbers(low[i], ref[i]) for i in idx])
