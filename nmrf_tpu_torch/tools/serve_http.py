"""Disparity-serving HTTP server over an exported artifact (root
``tools/serve_http.py``).

Loads a ``tools/export_serving.py`` artifact (frozen weights; on the card
its graph runs the hand-written kernels as the ``nmrf`` operators, and no
model code or config is needed) and serves:

  POST /disparity   body: .npz with ``img1``, ``img2`` ([H, W, 3] RGB f32,
                    0-255).  The pair is padded at the bottom and right by
                    edge replication to the artifact's shape (InputPadder
                    "proposal" semantics), moved to the artifact's device,
                    and the disparity is unpadded back.  Response: .npy
                    [H, W] f32, with the ``X-Timing-Ms`` header (pad_h2d,
                    dispatch, device_plus_readback, serialize).  A bad
                    request gets a 400 with the error text.
  GET  /healthz     200 + the artifact's sidecar JSON.

    python -m nmrf_tpu_torch.tools.serve_http --artifact serving/kitti.pt2 \\
        [--host 127.0.0.1] [--port 8000]

Single-threaded: one artifact, one request at a time; run one process per
card behind a load balancer.
"""

import argparse
import io
import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import torch


def make_handler(exported, meta):
    """The request handler class over a loaded artifact
    (``utils.export.load_exported``) of the frozen convention."""
    from ..utils.export import input_spec

    (_, eh, ew, _), device = input_spec(exported)
    users = [s for s in exported.graph_signature.input_specs
             if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    if len(users) != 2:
        raise ValueError("the server takes an artifact with frozen weights "
                         "(called with the two images only)")
    module = exported.module()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code, body, ctype="application/octet-stream",
                  headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for key, value in headers:
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, json.dumps(meta).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/disparity":
                return self._send(404, b"not found", "text/plain")
            try:
                n = int(self.headers.get("Content-Length", "0"))
                data = np.load(io.BytesIO(self.rfile.read(n)))
                img1 = np.asarray(data["img1"], np.float32)
                img2 = np.asarray(data["img2"], np.float32)
                if img1.ndim != 3 or img1.shape != img2.shape \
                        or img1.shape[2] != 3:
                    raise ValueError(f"img1 {img1.shape} and img2 "
                                     f"{img2.shape}: expected one [H, W, 3]")
                H, W, _ = img1.shape
                ph, pw = eh - H, ew - W
                if ph < 0 or pw < 0:
                    raise ValueError(
                        f"input {H}x{W} exceeds exported {eh}x{ew}")
                t0 = time.perf_counter()
                pad = ((0, ph), (0, pw), (0, 0))
                a1, a2 = (torch.from_numpy(np.pad(x, pad, mode="edge")[None])
                          .to(device) for x in (img1, img2))
                t1 = time.perf_counter()
                with torch.no_grad():
                    disp_dev = module(a1, a2)["disp"]
                t2 = time.perf_counter()  # the launches are queued
                disp = disp_dev.float().cpu().numpy()[0, :H, :W]  # waits
                t3 = time.perf_counter()
                buf = io.BytesIO()
                np.save(buf, disp)
                t4 = time.perf_counter()
                timing = {"pad_h2d": (t1 - t0) * 1e3,
                          "dispatch": (t2 - t1) * 1e3,
                          "device_plus_readback": (t3 - t2) * 1e3,
                          "serialize": (t4 - t3) * 1e3}
            except Exception as e:  # the client gets the error text
                return self._send(400, str(e).encode(), "text/plain")
            self._send(200, buf.getvalue(),
                       headers=[("X-Timing-Ms", json.dumps(timing))])

    return Handler


def main(argv=None):
    from ..utils.export import load_exported, load_meta

    ap = argparse.ArgumentParser("NMRF serving (PyTorch)")
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    args = ap.parse_args(argv)

    exported = load_exported(args.artifact)
    srv = HTTPServer((args.host, args.port),
                     make_handler(exported, load_meta(args.artifact)))
    print(f"serving {args.artifact} on {args.host}:{srv.server_port}",
          flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
