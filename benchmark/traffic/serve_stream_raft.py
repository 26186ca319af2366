"""Traffic generator: ``serve_stream``'s closed loop of one client's
KITTI-size requests through ``nmrf_tpu_torch.inference.predict``, served
by RAFT-Stereo (``MODEL.ARCH raft_stereo``), with ``serve_stream``'s
window, latencies and record keys, so that its readers read this cell
too.

Set-up builds the measured model from the configuration first (a
package without RAFT-Stereo refuses ``MODEL.ARCH`` there, before any
other work), makes the weights from the seed with the plain reference
(``benchmark/reference/raft_stereo.py``) on the card and loads them
(every key the package's model has; the reference's other keys are the
biases of the convolutions that an affine-free instance norm follows,
which the package's model leaves out), then the pool, the order and the
sampled requests as ``serve_stream`` makes them, and the warm-up.

A sampled request keeps, from hooks on the model: both images' ``fnet``
features, level 0 of the correlation pyramid, the 1/4 hidden state after
the first and the last iteration, and the 1/4 disparity after each
quarter of the iterations (8, 16, 24 and 32 of 32), besides the returned
disparity.  The check runs the float32 reference on the same padded pairs
and compares each (``raft_numbers``).  RAFT-Stereo makes no discrete
choice, so nothing of the program's enters the reference.

A traced run also records the iterations the traced requests ran (the
model's ``iterations`` after each), and the FLOPs of one request counted
on the reference at the served padded size."""

import numpy as np
import torch

from benchmark import frames, harness
from benchmark.reference import raft_stereo as raft
from benchmark.traffic import serve_stream


def rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-12))


def raft_numbers(prog, ref):
    """The compared numbers of one request: ``prog`` and ``ref`` dicts of
    host tensors: ``fmap`` (both images' features), ``corr0``, ``hidden``
    and ``disp_lowres`` ({iteration: map}) and ``disp`` (unpadded)."""
    return {
        "fmap_rel": rel(prog["fmap"], ref["fmap"]),
        "corr_rel": rel(prog["corr0"], ref["corr0"]),
        "hidden_rel": max(rel(prog["hidden"][t], ref["hidden"][t])
                          for t in ref["hidden"]),
        "disp_lowres_px": max(float((prog["disp_lowres"][t]
                                     - ref["disp_lowres"][t]).abs().mean())
                              for t in ref["disp_lowres"]),
        "epe_px": float((prog["disp"] - ref["disp"]).abs().mean()),
    }


def _host(x):
    return x.detach().float().cpu()


class Generator(serve_stream.Generator):
    def __init__(self, cell, seed, device, trace=False):
        super().__init__(cell, seed, device, trace)
        iters = self.spec["RAFT.VALID_ITERS"]
        self.keep_hidden = (1, iters)
        self.keep_disp = tuple(iters * k // 4 for k in range(1, 5))

    # ---- set-up ----------------------------------------------------------

    def weights(self):
        return raft.init_weights(raft.build(self.spec, self.device), self.seed)

    def setup(self):
        from nmrf_tpu_torch.inference import predict
        from nmrf_tpu_torch.models import build_model

        cfg = harness.port_cfg(self.spec, self.seed)
        self.predict = predict
        ref = self.weights().state_dict()
        self.model = build_model(cfg, device=self.device)
        own = self.model.state_dict()
        left = [k for k in ref if k not in own]
        if any(not (k.startswith("fnet.") and k.endswith(".bias"))
               for k in left):
            raise SystemExit(f"reference keys the program lacks: {left}")
        self.model.load_state_dict({k: v for k, v in ref.items()
                                    if k in own})
        del ref
        harness.free(self.device)
        self.inputs()
        self.kept, self.capture, self.iters_run = {}, None, 0
        self._hooks()
        for i in range(self.p["warmup"]):
            self.predict(self.model, *self.pool[i % self.p["pool"]])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _hooks(self):
        m = self.model

        def keep(key, pick):
            def hook(module, args, out):
                if self.capture is not None:
                    self.capture[key] = pick(out)
            return hook

        def update(module, args, out):
            if self.capture is None:
                return
            t = self.capture["calls"] = self.capture.get("calls", 0) + 1
            if t in self.keep_hidden:
                self.capture[("hidden", t)] = out[0][0]
            if t - 1 in self.keep_disp:
                self.capture[("disp_lowres", t - 1)] = -args[3][..., 0]

        m.fnet.register_forward_hook(keep("fmap", lambda o: o))
        m.corr_block.register_forward_hook(
            keep("corr0", lambda o: o[..., :o.shape[2]]))
        m.update_block.register_forward_hook(update)
        m.register_forward_hook(keep("last", lambda o: o["disp_lowres"]))

    # ---- the window -----------------------------------------------------

    def request(self, i):
        super().request(i)
        self.iters_run += self.model.iterations

    def trace(self, path):
        self.iters_run = 0
        rec = super().trace(path)
        rec["raft_iterations"] = self.iters_run
        return rec

    def flops(self):
        """FLOPs of one request, counted on the reference on the meta
        device at the served padded size."""
        from torch.utils.flop_counter import FlopCounterMode

        model = raft.build(self.spec, "meta")
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
            last = max(self.keep_disp)
            k[("disp_lowres", last)] = k["last"]
            out[i] = {
                "fmap": _host(k["fmap"]), "corr0": _host(k["corr0"]),
                "hidden": {t: _host(k[("hidden", t)])
                           for t in self.keep_hidden},
                "disp_lowres": {t: _host(k[("disp_lowres", t)])
                                for t in self.keep_disp},
                "disp": torch.from_numpy(np.asarray(k["disp"]))}
        return out

    def reference_outputs(self, indices, fp8=False, fault=None):
        """The reference's outputs on the requests ``indices``, float32 (or
        the control: its float8 form; or with one of ``raft.FAULTS``)."""
        with harness.strict_f32():
            model = self.weights()
            raft.set_fp8(model, fp8)
            model.set_fault(fault)
            div = self.spec["DATASETS.DIVIS_BY"]
            H, W = self.p["height"], self.p["width"]
            out = {}
            with torch.no_grad():
                for i in indices:
                    a, b = self.pool[self.order[i % len(self.order)]]
                    x = [torch.from_numpy(frames.pad_to(f, div)[None].astype(
                        np.float32)).to(self.device) for f in (a, b)]
                    o = model(*x, keep_hidden=self.keep_hidden,
                              keep_disp=self.keep_disp)
                    out[i] = {
                        "fmap": _host(torch.cat([o["fmap1"], o["fmap2"]])),
                        "corr0": _host(o["corr0"]),
                        "hidden": {t: _host(v) for t, v in o["hidden"].items()},
                        "disp_lowres": {t: _host(v) for t, v in
                                        o["disp_lowres"].items()},
                        "disp": _host(o["disp"][0, :H, :W])}
            del model
            harness.free(self.device)
            return out

    def check(self):
        prog = self.program_outputs()
        self.kept.clear()
        del self.model
        harness.free(self.device)
        ref = self.reference_outputs(sorted(prog))
        numbers = serve_stream.worst([raft_numbers(prog[i], ref[i])
                                      for i in prog])
        harness.log(f"compared {len(prog)} requests of {self.done}: "
                    f"{sorted(prog)}")
        return numbers

    def control(self):
        """The control's numbers: the float8 reference in the program's
        place on the sampled requests."""
        return self.fault(None, fp8=True)

    def fault(self, name, fp8=False):
        """A fault's numbers (``raft.FAULTS``), planted in the reference put
        in the program's place on the sampled requests."""
        idx = sorted(self.sample)
        bad = self.reference_outputs(idx, fp8=fp8, fault=name)
        ref = self.reference_outputs(idx)
        return serve_stream.worst([raft_numbers(bad[i], ref[i]) for i in idx])
