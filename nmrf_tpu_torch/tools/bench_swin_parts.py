"""The swin backbone's latency by part on the card: the whole adaptor, the
Swin-T transformer, the deformable neck and the tap MSDA kernel B5 alone
(``tools/bench_swin_parts.py``).

    python -m nmrf_tpu_torch.tools.bench_swin_parts [--iters N] [--device cuda]
        [KEY VALUE ...]

At the KITTI-padded 384x1280 (``BENCH_HW HxW`` overrides it), bf16, the
swin config (``configs/sceneflow_swint.yaml``) with random weights from
``cfg.SEED``; each part by ``chained_ms`` over ``--iters`` (default 20) calls.
The neck takes random per-level features; B5 (``ops/msda.py:msda_taps``)
runs at the neck's query grid (1/4 of the image) against a level map of
the same size (f 1) and of half the size (f 2), 8 heads of 8 channels and
4 points, displacements uniform within the tap radius.  Prints one JSON
line per part, ``{"part", "ms"}``.
"""

import argparse
import json
import os

import numpy as np
import torch

from .flops import SWIN_CONFIG


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20,
                   help="chained calls a part (the JAX tool's ITERS)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None):
    """Time the parts; prints and returns [{"part", "ms"}]."""
    from ..config import get_cfg
    from ..models import build_model, resolve_device
    from ..ops.msda import msda_taps
    from ..utils.benchmarks import chained_ms, parse_hw

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_cfg()
    cfg.merge_from_file(str(SWIN_CONFIG))
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    adaptor = build_model(cfg, device=device).backbone
    dtype = torch.bfloat16
    H, W = parse_hw(os.environ.get("BENCH_HW", "384x1280"))
    rng = np.random.RandomState(0)

    def rand(*shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy((rng.rand(*shape) * scale).astype(
            np.float32)).to(device, dt)

    rows = []

    def timed(part, fn, *inputs):
        ms = chained_ms(fn, *inputs, iters=args.iters)
        rows.append({"part": part, "ms": round(ms, 2)})
        print(json.dumps(rows[-1]), flush=True)

    img = rand(1, H, W, 3, scale=255.0)
    timed("swin_adaptor_total", lambda x: adaptor(x)[0], img)
    timed("swin_transformer", lambda x: adaptor.backbone(x)[-1], img)
    feats = [rand(1, H // s, W // s, c, dt=dtype)
             for s, c in ((4, 96), (8, 192), (16, 384), (32, 768))]
    timed("deform_neck", lambda x, f: adaptor.neck(x, f), img, feats)

    Hq, Wq = H // 4, W // 4
    M, D, P = 8, 8, 4  # heads, channels a head (128 * 0.5 / 8), points
    r = cfg.TPU.MSDA_TAP_RADIUS
    for lvl, f in enumerate((1, 2)):
        value = rand(1, Hq // f, Wq // f, M * D, dt=dtype)
        dx, dy = (rand(1, Hq, Wq, M * P, scale=2 * r - 1) - (r - 0.5)
                  for _ in range(2))
        aw = rand(1, Hq, Wq, M * P)
        timed(f"msda_core_l{lvl}",
              lambda v, a, b, w: msda_taps(v, a, b, w, M, r),
              value, dx, dy, aw)
    return rows


if __name__ == "__main__":
    main()
