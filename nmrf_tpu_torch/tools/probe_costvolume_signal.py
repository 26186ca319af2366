"""How much correspondence signal the cost volume carries at random init
(the counterpart of ``tools/probe_costvolume_signal.py``, same pairs, same
lines).

The model at random init from ``cfg.SEED`` (``TPU.COMPUTE_DTYPE
bfloat16``) runs only its backbone (``extract_feature``) and the group
correlation (``ops/correlation.py``) on random-dot pairs; the volume is
summed over the groups and its argmax over the D disparity bins is held
against the ground truth at 1/8 resolution (the centre sample of each 8x8
block, ``[3::8, 3::8]``):

* ``aligned8``: disparities on multiples of 8 px (whole 1/8 bins), where
  the right patch at the true shift is the same dots, so any deterministic
  feature map's correlation peaks at the true bin;
* ``unaligned``: ``data/synthetic.py:make_stereo_pair``'s own disparities,
  between bins, where what accuracy remains must be learned.

    python -m nmrf_tpu_torch.tools.probe_costvolume_signal [--device cuda]
        [--height 192] [--width 384] [--seeds 4] [KEY VALUE ...]

Prints ``{kind}: raw cost-volume argmax exact-bin acc A, within-1-bin B``
for each kind (exact bin: |argmax - GT/8| <= 0.5; within one bin: <=
1.5), four seeds (``RandomState(100 + s)``) of each, max_disp 48.
"""

import argparse

import numpy as np
import torch

KINDS = ("aligned8", "unaligned")


def aligned_pair(H, W, max_disp, rng):
    """Random-dot pair whose disparities are multiples of 8 (bin-exact):
    ``make_stereo_pair``'s scene with its disparities rounded to whole
    bins (at least one) and the left view warped again."""
    from ..data.synthetic import make_stereo_pair

    _, i2, d, _ = make_stereo_pair(H, W, max_disp=max_disp, rng=rng)
    dq = np.maximum(np.round(d / 8.0), 1.0) * 8.0
    xs = np.arange(W)
    di = dq.astype(np.int64)
    i1q = i2[np.arange(H)[:, None], np.clip(xs[None, :] - di, 0, W - 1), :]
    vq = (xs[None, :] - di) >= 0
    return i1q, i2, dq.astype(np.float32), vq


def probe_pairs(kind, H, W, seeds=4, max_disp=48):
    """The probe's pairs of one kind: [(img1, img2, disp, valid)] from
    ``RandomState(100 + s)`` for s < seeds."""
    from ..data.synthetic import make_stereo_pair

    pairs = []
    for s in range(seeds):
        rng = np.random.RandomState(100 + s)
        if kind == "aligned8":
            pairs.append(aligned_pair(H, W, max_disp, rng))
        else:
            pairs.append(make_stereo_pair(H, W, max_disp=max_disp, rng=rng))
    return pairs


def cost_volume_argmax(model, img1, img2):
    """The argmax over the D bins of the group-summed correlation volume of
    the model's 1/8 features: [B, H/8, W/8] int64 (the backbone in eval
    mode, no gradient)."""
    from ..ops.correlation import correlation_volume

    model.eval()
    with torch.inference_mode():
        f1, f2 = model.extract_feature(img1, img2)
        cv = correlation_volume(f1[0], f2[0], model.max_disp // 8,
                                model.cost_group)
        return cv.float().sum(3).argmax(-1)


def cost_argmax_accuracy(model, pairs):
    """(exact-bin accuracy, within-1-bin accuracy) of the cost volume's
    argmax over ``pairs`` [(img1, img2, disp, valid)], each the mean over
    the pair's valid 1/8 centre samples, averaged over the pairs."""
    device = next(model.parameters()).device
    accs, acc1s = [], []
    for img1, img2, disp, valid in pairs:
        a, b = (torch.from_numpy(np.ascontiguousarray(x, np.float32)[None])
                .to(device) for x in (img1, img2))
        top1 = cost_volume_argmax(model, a, b)[0].cpu().numpy()
        g8 = disp[3::8, 3::8] / 8.0
        v8 = valid[3::8, 3::8]
        err = np.abs(top1 - g8)
        accs.append((err[v8] <= 0.5).mean())
        acc1s.append((err[v8] <= 1.5).mean())
    return float(np.mean(accs)), float(np.mean(acc1s))


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None):
    """Run the probe; prints a line per kind and returns {kind: (acc,
    acc1)}."""
    from ..config import get_cfg
    from ..models import build_model, resolve_device

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    model = build_model(cfg, device=device)
    result = {}
    for kind in KINDS:
        acc, acc1 = cost_argmax_accuracy(
            model, probe_pairs(kind, args.height, args.width, args.seeds))
        result[kind] = (acc, acc1)
        print(f"{kind}: raw cost-volume argmax exact-bin acc {acc:.3f}, "
              f"within-1-bin {acc1:.3f}", flush=True)
    return result


if __name__ == "__main__":
    main()
