"""Per-stage latency of the NMRF forward on the card
(``tools/bench_stages.py``).

    python -m nmrf_tpu_torch.tools.bench_stages [--device cuda] [KEY VALUE ...]

Times each stage of the eval forward alone, through the model's own
submodules (``models/nmrf.py:NMRF.decode``): the backbone, the cost volume
and DPN, the Inference stage with its heads, the Refinement stage with its
head, then their sum and the whole forward, each by ``chained_ms`` (16
chained calls, every floating input perturbed by the previous output's zero
token).  The stages' inputs are made once from one forward of the
benchmark pair (KITTI 375x1242 padded; ``BENCH_HW HxW`` overrides it),
bf16.  Prints one JSON line per stage, ``{"stage", "ms"}``.
"""

import argparse
import json
import os

import numpy as np
import torch

K = 16


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def stage_functions(model):
    """{stage: fn(inputs)} over the model's submodules, as ``NMRF.decode``
    runs them; ``inputs`` is the tuple :func:`stage_inputs` gives."""
    from ..ops.correlation import correlation_volume

    def backbone(x):
        img1, img2 = x
        return model.extract_feature(img1, img2)

    def costvol_dpn(x):
        f1, f2 = x
        cv = correlation_volume(f1[0], f2[0], model.max_disp // 8,
                                model.cost_group)
        return model.dpn(cv, f1[0])

    def inference(x):
        f1, f2, labels = x
        tgt = model.inference(labels, model.concatconv(f1[0]),
                              model.concatconv(f2[0]), model.gw(f1[0]),
                              model.gw(f2[0]))
        return model.infer_head(tgt), 0.25 * model.infer_score_head(tgt)

    def refinement(x):
        f1, f2, disp = x
        tgt = model.refinement(disp, model.concatconv(f1[1]),
                               model.concatconv(f2[1]), model.gw(f1[1]),
                               model.gw(f2[1]))
        return model.refine_head(tgt)

    def full(x):
        return model(*x)["disp"]

    return {"backbone": backbone, "costvol+dpn": costvol_dpn,
            "inference_nmp": inference, "refinement_nmp": refinement,
            "full_forward": full}


def stage_inputs(model, img1, img2, seed=0):
    """{stage: its inputs}: the features and DPN labels of one forward of
    the pair; the Refinement's disparity uniform in [0, 80) from numpy
    ``RandomState(seed)`` (as the JAX tool draws it)."""
    from ..ops.correlation import correlation_volume

    with torch.inference_mode():
        f1, f2 = model.extract_feature(img1, img2)
        cv = correlation_volume(f1[0], f2[0], model.max_disp // 8,
                                model.cost_group)
        labels = model.dpn(cv, f1[0])[2]
    B, h8, w8 = f1[0].shape[:3]
    labels = labels[-1].reshape(B, h8, w8, model.num_proposals)
    H4, W4 = f1[1].shape[1:3]
    disp = torch.from_numpy((np.random.RandomState(seed).rand(B, H4, W4) * 80)
                            .astype(np.float32)).to(img1.device)
    return {"backbone": (img1, img2), "costvol+dpn": (f1, f2),
            "inference_nmp": (f1, f2, labels),
            "refinement_nmp": (f1, f2, disp), "full_forward": (img1, img2)}


def main(argv=None):
    """Time the stages; prints and returns [{"stage", "ms"}]."""
    from ..config import get_cfg
    from ..models import build_model, resolve_device
    from ..utils.benchmarks import KITTI_HW, chained_ms, kitti_inputs, parse_hw

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    model = build_model(cfg, device=device)
    hw = parse_hw(os.environ["BENCH_HW"]) if os.environ.get("BENCH_HW") \
        else KITTI_HW
    img1, img2 = kitti_inputs(cfg, device, hw)
    fns = stage_functions(model)
    inputs = stage_inputs(model, img1, img2)

    rows = []

    def timed(name):
        ms = chained_ms(fns[name], inputs[name], iters=K)
        rows.append({"stage": name, "ms": round(ms, 2)})
        print(json.dumps(rows[-1]), flush=True)
        return ms

    total = sum(timed(name) for name in ("backbone", "costvol+dpn",
                                         "inference_nmp", "refinement_nmp"))
    rows.append({"stage": "sum_of_stages", "ms": round(total, 2)})
    print(json.dumps(rows[-1]), flush=True)
    timed("full_forward")
    return rows


if __name__ == "__main__":
    main()
