"""Export the eval forward as a serving artifact (root
``tools/export_serving.py``).

Builds the model from a config (and ``SOLVER.RESUME``, through the CLI's
``inference.build``), exports its eval forward with ``torch.export`` at one
padded input shape on ``--device`` and writes the artifact with its JSON
sidecar to ``--output`` (``utils/export.py``).  On the card the graph runs
the hand-written kernels as the ``nmrf`` operators.  The exported shape is
(batch, H, W, 3) with H and W padded up to ``DATASETS.DIVIS_BY``; pad
inputs with ``data.frame_io.InputPadder(mode="proposal")`` at serve time
(``tools/serve_http.py`` does).

    python -m nmrf_tpu_torch.tools.export_serving --height 375 --width 1242 \\
        --output serving/kitti.pt2 [--device cpu] [--check] [--no-freeze] \\
        [--config-file configs/...yaml] [KEY VALUE ...]
"""

import argparse
import os
import time

import numpy as np
import torch


def pad_up(v, k):
    return -(-v // k) * k


def get_args_parser():
    ap = argparse.ArgumentParser("NMRF serving export (PyTorch)")
    ap.add_argument("--config-file", default="", metavar="FILE")
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--output", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--no-freeze", action="store_true",
                    help="export a (params, img1, img2) calling convention "
                         "instead of baking the weights in")
    ap.add_argument("--check", action="store_true",
                    help="round-trip the artifact and compare against the "
                         "live model on the same device")
    ap.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return ap


def export_artifact(model, cfg, height, width, output, batch=1, freeze=True,
                    config_file=""):
    """Export ``model``'s eval forward at (batch, height, width) padded up
    to ``cfg.DATASETS.DIVIS_BY`` and save it to ``output``.  Returns
    (exported program, input shape, size in bytes, export seconds)."""
    from ..utils.export import export_eval, save_exported

    k = cfg.DATASETS.DIVIS_BY
    shape = (batch, pad_up(height, k), pad_up(width, k), 3)
    t0 = time.perf_counter()
    exported = export_eval(model, shape, freeze_params=freeze)
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    size = save_exported(exported, output, extra_meta={
        "config_file": config_file, "divis_by": k,
        "model": cfg.BACKBONE.MODEL_TYPE,
        "compute_dtype": cfg.TPU.COMPUTE_DTYPE})
    return exported, shape, size, seconds


def check_artifact(path, model, shape, freeze=True, seed=0):
    """Max |delta| over the outputs of the loaded artifact and the live
    model on one random input pair of ``shape`` on the model's device."""
    from ..utils.export import load_exported

    module = load_exported(path).module()
    device = next(model.parameters()).device
    rng = np.random.RandomState(seed)
    a, b = (torch.from_numpy(rng.rand(*shape).astype(np.float32) * 255)
            .to(device) for _ in range(2))
    with torch.no_grad():
        if freeze:
            got = module(a, b)
        else:
            got = module({k: v.detach() for k, v in model.named_parameters()},
                         a, b)
        want = model(a, b)
    if got.keys() != want.keys():
        raise AssertionError(f"outputs {sorted(got)} != {sorted(want)}")
    return max(float((got[k].float() - want[k].float()).abs().max())
               for k in want)


def main(argv=None):
    from ..inference import build

    args = get_args_parser().parse_args(argv)
    cfg, model = build(args)
    freeze = not args.no_freeze
    _, shape, size, seconds = export_artifact(
        model, cfg, args.height, args.width, args.output, args.batch, freeze,
        args.config_file)
    print(f"exported the eval forward at {shape} on {args.device} "
          f"(freeze={freeze}) in {seconds:.1f} s")
    print(f"wrote {args.output} ({size / 1e6:.1f} MB) + sidecar .json")
    if args.check:
        err = check_artifact(args.output, model, shape, freeze)
        print(f"round-trip max |delta| = {err:.3e}")
        if not err < 1e-4:
            raise SystemExit(f"round trip differs from the live model: {err}")
    return size


if __name__ == "__main__":
    main()
