"""The roofline of IGEV-Stereo's volume stage (``nmrf::igev.volume``: the
group-wise correlation volume through the starting disparity) against the
H100's published peaks (``arith.HBM_BYTES_PER_S``, ``arith.BF16_OPS_PER_S``),
beside the frozen ``arith.py``.

The stage's ops at the 1/4 size of an H x W frame, D = max_disp / 4
disparities, in the measured package's dtypes:

- the volume: 8 groups of the 96-channel matching features (bf16), one
  multiply-add a channel for each pixel and disparity inside the row (2
  FLOPs), the bf16 volume [B, D, h, w, 8] written;
- every 3-D and 2-D convolution of ``corr_stem``, the ``FeatureAtt`` gates,
  the hourglass and ``classifier``: 2 FLOPs a multiply-add, as
  ``torch.utils.flop_counter`` counts a convolution (a transposed one over
  its input's positions); its bf16 input, output and weights once, its norm
  and activation taken as fused into it;
- each gate's product with the volume: the volume read and written and the
  gate read once (no FLOPs counted);
- the soft-argmin: the bf16 logits read, the float32 disparity written,
  ``SOFTARGMIN_OPS`` FLOPs a logit (max, subtract, exp, sum, divide, and the
  expectation's multiply-add).

Concatenations, layout copies and casts count nothing: a fused kernel makes
none.  The least time is max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s)."""

import math

from benchmark import arith

GROUPS = 8
MATCH = 96
BF16, F32 = 2, 4
SOFTARGMIN_OPS = 7


def _conv(ops, name, spatial, cin, cout, k, stride=1, transposed=False):
    """Append a convolution over ``spatial`` (its input's sizes); returns
    its output's sizes."""
    nd = len(spatial)
    if transposed:
        out = tuple(s * stride for s in spatial)
        positions = math.prod(spatial)
    else:
        out = tuple(s // stride for s in spatial)
        positions = math.prod(out)
    taps = k ** nd
    ops.append({"op": name, "kind": "conv",
                "flops": 2 * positions * taps * cin * cout,
                "bytes": BF16 * (math.prod(spatial) * cin
                                 + math.prod(out) * cout + taps * cin * cout),
                "weights": BF16 * taps * cin * cout})
    return out


def _gate(ops, name, vol, c, feat, feat_ch):
    """``FeatureAtt``: two 1 x 1 convolutions of the features, and the
    gate's product with the volume."""
    _conv(ops, f"{name}.feat_att.0", feat, feat_ch, feat_ch // 2, 1)
    _conv(ops, f"{name}.feat_att.1", feat, feat_ch // 2, c, 1)
    n = math.prod(vol) * c
    ops.append({"op": f"{name}.gate", "kind": "gate", "flops": 0,
                "bytes": BF16 * (2 * n + math.prod(feat) * c)})


def volume_ops(batch, height, width, max_disp):
    """The stage's ops at one padded frame size: a list of {"op", "kind",
    "flops", "bytes"}, batch folded in."""
    h, w, d = height // 4, width // 4, max_disp // 4
    ops = []
    valid = sum(max(w - i, 0) for i in range(d))
    ops.append({"op": "gwc_volume", "kind": "volume",
                "flops": 2 * h * valid * MATCH,
                "bytes": BF16 * (2 * h * w * MATCH + d * h * w * GROUPS)})
    vol = (d, h, w)
    feats = {s: (h // s, w // s) for s in (1, 2, 4, 8)}
    _conv(ops, "corr_stem", vol, GROUPS, GROUPS, 3)
    _gate(ops, "corr_feature_att", vol, GROUPS, feats[1], 96)
    c = GROUPS
    v2 = _conv(ops, "conv1.0", vol, c, 2 * c, 3, 2)
    _conv(ops, "conv1.1", v2, 2 * c, 2 * c, 3)
    _gate(ops, "feature_att_8", v2, 2 * c, feats[2], 64)
    v4 = _conv(ops, "conv2.0", v2, 2 * c, 4 * c, 3, 2)
    _conv(ops, "conv2.1", v4, 4 * c, 4 * c, 3)
    _gate(ops, "feature_att_16", v4, 4 * c, feats[4], 192)
    v8 = _conv(ops, "conv3.0", v4, 4 * c, 6 * c, 3, 2)
    _conv(ops, "conv3.1", v8, 6 * c, 6 * c, 3)
    _gate(ops, "feature_att_32", v8, 6 * c, feats[8], 160)
    _conv(ops, "conv3_up", v8, 6 * c, 4 * c, 4, 2, transposed=True)
    _conv(ops, "agg_0.0", v4, 8 * c, 4 * c, 1)
    _conv(ops, "agg_0.1", v4, 4 * c, 4 * c, 3)
    _conv(ops, "agg_0.2", v4, 4 * c, 4 * c, 3)
    _gate(ops, "feature_att_up_16", v4, 4 * c, feats[4], 192)
    _conv(ops, "conv2_up", v4, 4 * c, 2 * c, 4, 2, transposed=True)
    _conv(ops, "agg_1.0", v2, 4 * c, 2 * c, 1)
    _conv(ops, "agg_1.1", v2, 2 * c, 2 * c, 3)
    _conv(ops, "agg_1.2", v2, 2 * c, 2 * c, 3)
    _gate(ops, "feature_att_up_8", v2, 2 * c, feats[2], 64)
    _conv(ops, "conv1_up", v2, 2 * c, GROUPS, 4, 2, transposed=True)
    _conv(ops, "classifier", vol, GROUPS, 1, 3)
    logits = d * h * w
    ops.append({"op": "soft_argmin", "kind": "softargmin",
                "flops": SOFTARGMIN_OPS * logits,
                "bytes": BF16 * logits + F32 * h * w})
    for op in ops:  # a conv's weights are read once for the whole batch
        weights = op.pop("weights", 0)
        op["flops"] *= batch
        op["bytes"] = (op["bytes"] - weights) * batch + weights
    return ops


def volume_least_ms(batch, height, width, max_disp):
    """(least ms, bytes ms, FLOPs ms) of the stage: max of the two."""
    ops = volume_ops(batch, height, width, max_disp)
    nbytes = sum(op["bytes"] for op in ops)
    flops = sum(op["flops"] for op in ops)
    bytes_ms = nbytes / arith.HBM_BYTES_PER_S * 1e3
    ops_ms = flops / arith.BF16_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms
