"""Check the tap MSDA's exactness precondition for a checkpoint
(``tools/check_tap_coverage.py``).

    python -m nmrf_tpu_torch.tools.check_tap_coverage [--hw HxW]
        [--config-file FILE] [--device cuda] [KEY VALUE ...]
    # e.g. --hw 375x1242 --config-file configs/sceneflow_swint.yaml \\
    #      SOLVER.RESUME kitti_swint.pth

The tap path (``TPU.MSDA_TAP_RADIUS``, kernel B5) drops the contribution of
every sampling point displaced more than the radius from its query's
aligned cell.  Offsets start within 4 level pixels; trained ones are
unconstrained, so run this on a trained checkpoint (``SOLVER.RESUME``: an
upstream ``.pth`` or a checkpoint directory of ``python -m
nmrf_tpu_torch.train``, loaded as ``inference.build`` loads it) to see
whether the radius covers it, or to pick a larger one or the exact path
(``TPU.MSDA_TAP_RADIUS 0``).  One forward of a random frame (numpy
``RandomState(0)``, padded as the bench pads) with a hook on every
extractor of the deformable neck reports, per extractor and level, the
share of samples the tap span drops.  Exits 1 if any share is above 0.
"""

import argparse
import sys

import torch


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hw", default="128x256")
    p.add_argument("--config-file", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def tap_coverage(model, img1, img2):
    """One eval forward of the padded pair with a hook on every extractor's
    deformable attention.  Returns, per extractor, {"taps": whether it took
    the tap path, "levels": its level shapes, "oob_fractions": per level
    the share of its samples beyond the tap radius}."""
    from ..ops.msda import tap_out_of_range_fractions

    report = []

    def hook(module, args, _output):
        query, ref, _flat, shapes, query_shape = args
        locations, _ = module.sampling(query, ref, shapes)
        report.append({
            "taps": module.uses_taps(query.shape[1], shapes, query_shape),
            "levels": [list(s) for s in shapes],
            "oob_fractions": tap_out_of_range_fractions(
                locations, shapes, query_shape, module.tap_radius).tolist()})

    handles = [e.attn.register_forward_hook(hook)
               for e in model.backbone.neck.extractors]
    try:
        with torch.inference_mode():
            model(img1, img2)
    finally:
        for h in handles:
            h.remove()
    return report


def main(argv=None):
    """Returns the exit code: 1 if the tap span drops samples, else 0."""
    from ..inference import build
    from ..utils.benchmarks import kitti_inputs, parse_hw

    args = _parser().parse_args(argv)
    cfg, model = build(args)
    if cfg.BACKBONE.MODEL_TYPE != "swin":
        print("resnet backbone has no MSDA; nothing to check")
        return 0
    img, _ = kitti_inputs(cfg, next(model.parameters()).device,
                          parse_hw(args.hw))
    report = tap_coverage(model, img, img)
    if not any(r["taps"] for r in report):
        print("tap path inactive (TPU.MSDA_TAP_RADIUS is 0?); nothing to "
              "check")
        return 0
    worst = 0.0
    for i, r in enumerate(report):
        for level, frac in zip(r["levels"], r["oob_fractions"]):
            worst = max(worst, frac)
            print(f"neck.extractors.{i} level {level[0]}x{level[1]} "
                  f"oob_fraction={frac:.2e}")
    print(f"max out-of-range fraction: {worst:.3e} "
          f"(radius {cfg.TPU.MSDA_TAP_RADIUS})")
    if worst > 0:
        print("WARNING: the tap kernel drops contributions for this "
              "checkpoint; raise TPU.MSDA_TAP_RADIUS or set it to 0.")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
