"""Traffic generator: ``serve_stream``'s closed loop of one client's
KITTI-size requests through ``nmrf_tpu_torch.inference.predict``, served
by IGEV-Stereo (``MODEL.ARCH igev_stereo``), with ``serve_stream``'s
window, latencies and record keys, so that its readers read this cell
too.  It is ``serve_stream_raft``'s generator with IGEV-Stereo's
reference, hooks and compared numbers.

Set-up builds the measured model's configuration first (a package without
IGEV-Stereo refuses ``IGEV.MAX_DISP`` or ``MODEL.ARCH`` there, before any
other work), makes the weights from the seed with the plain reference
(``benchmark/reference/igev_stereo.py``) on the card and loads them (every
key: both models hold upstream's), then the pool, the order and the
sampled requests as ``serve_stream`` makes them, and the warm-up.

A sampled request keeps, from hooks on the model: both images' matching
features (``desc``), the hourglass's output volume (``cost_agg``), the
starting disparity, the 1/4 hidden state after the first and the last
iteration, and the 1/4 disparity after each quarter of the iterations (8,
16, 24 and 32 of 32), besides the returned disparity.  The check runs the
float32 reference on the same padded pairs and compares each
(``igev_numbers``).

A traced run also records the iterations the traced requests ran, the
served padded size for the volume stage's roofline (``igev_volume``), and
the FLOPs of one request counted on the reference at that size."""

import numpy as np
import torch

from benchmark import frames, harness
from benchmark.reference import igev_stereo as igev
from benchmark.traffic import serve_stream, serve_stream_raft


def igev_numbers(prog, ref):
    """The compared numbers of one request: ``prog`` and ``ref`` dicts of
    host tensors: ``match`` (both images' matching features), ``geo`` (the
    hourglass's output), ``init_disp``, ``hidden`` and ``disp_lowres``
    ({iteration: map}) and ``disp`` (unpadded)."""
    rel = serve_stream_raft.rel
    return {
        "match_rel": rel(prog["match"], ref["match"]),
        "geo_rel": rel(prog["geo"], ref["geo"]),
        "init_disp_px": float((prog["init_disp"] - ref["init_disp"])
                              .abs().mean()),
        "hidden_rel": max(rel(prog["hidden"][t], ref["hidden"][t])
                          for t in ref["hidden"]),
        "disp_lowres_px": max(float((prog["disp_lowres"][t]
                                     - ref["disp_lowres"][t]).abs().mean())
                              for t in ref["disp_lowres"]),
        "epe_px": float((prog["disp"] - ref["disp"]).abs().mean()),
    }


_host = serve_stream_raft._host


class Generator(serve_stream_raft.Generator):

    # ---- set-up ----------------------------------------------------------

    def weights(self):
        return igev.init_weights(igev.build(self.spec, self.device), self.seed)

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
                self.capture[("disp_lowres", t - 1)] = args[3][..., 0]

        m.desc.register_forward_hook(keep("match", lambda o: o))
        m.cost_agg.register_forward_hook(keep("geo", lambda o: o))
        m.update_block.register_forward_hook(update)
        m.register_forward_hook(keep("last", lambda o: (o["disp_lowres"],
                                                        o["init_disp"])))

    # ---- the window -----------------------------------------------------

    def padded(self):
        """The served padded (H, W)."""
        return frames.pad_to(np.zeros((self.p["height"], self.p["width"], 1),
                                      np.uint8),
                             self.spec["DATASETS.DIVIS_BY"]).shape[:2]

    def trace(self, path):
        rec = super().trace(path)
        H, W = self.padded()
        rec["igev_volume"] = {"batch": 1, "height": H, "width": W,
                              "max_disp": self.spec["IGEV.MAX_DISP"]}
        return rec

    def flops(self):
        """FLOPs of one request, counted on the reference on the meta
        device at the served padded size."""
        from torch.utils.flop_counter import FlopCounterMode

        model = igev.build(self.spec, "meta")
        x = torch.zeros(1, *self.padded(), 3, device="meta")
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x, x)
        return counter.get_total_flops()

    # ---- the output check -----------------------------------------------

    def program_outputs(self):
        """The kept requests' outputs on the host, by request index."""
        out = {}
        for i, k in sorted(self.kept.items()):
            last, init = k["last"]
            k[("disp_lowres", max(self.keep_disp))] = last
            out[i] = {
                "match": _host(k["match"]), "geo": _host(k["geo"]),
                "init_disp": _host(init),
                "hidden": {t: _host(k[("hidden", t)])
                           for t in self.keep_hidden},
                "disp_lowres": {t: _host(k[("disp_lowres", t)])
                                for t in self.keep_disp},
                "disp": torch.from_numpy(np.asarray(k["disp"]))}
        return out

    def reference_outputs(self, indices, fp8=False, fault=None):
        """The reference's outputs on the requests ``indices``, float32 (or
        the control: its float8 form; or with one of ``igev.FAULTS``)."""
        with harness.strict_f32():
            model = self.weights()
            igev.set_fp8(model, fp8)
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
                        "match": _host(o["match"]), "geo": _host(o["geo"]),
                        "init_disp": _host(o["init_disp"]),
                        "hidden": {t: _host(v)
                                   for t, v in o["hidden"].items()},
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
        numbers = serve_stream.worst([igev_numbers(prog[i], ref[i])
                                      for i in prog])
        harness.log(f"compared {len(prog)} requests of {self.done}: "
                    f"{sorted(prog)}")
        return numbers

    def fault(self, name, fp8=False):
        """A fault's numbers (``igev.FAULTS``), planted in the reference put
        in the program's place on the sampled requests."""
        idx = sorted(self.sample)
        bad = self.reference_outputs(idx, fp8=fp8, fault=name)
        ref = self.reference_outputs(idx)
        return serve_stream.worst([igev_numbers(bad[i], ref[i]) for i in idx])
