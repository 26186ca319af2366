"""Model FLOPs and MFU of the port on the H100 (``tools/flops.py``), and
the roofline arithmetic of the measurement scripts and ``chip_smoke.py``.

    python -m nmrf_tpu_torch.tools.flops [--infer-ms MS] [--swin-ms MS]
        [--train-ms MS] [--fused-train-ms MS] [--swin-train-ms MS]
        [--train-batch 8] [--peak-tflops 989] [--device cuda]
        [--out FLOPS_H100.json] [KEY VALUE ...]

The count.  ``torch.utils.flop_counter.FlopCounterMode`` over the model on
its plain path (``TPU.USE_PALLAS False``, ``TPU.MSDA_TAP_RADIUS 0``: the
JAX tool's golden configuration, attentions counted dense), at 2 FLOPs a
multiply-add of every matmul and convolution, forward and backward.  Eager
PyTorch runs every layer, so every layer is counted: XLA's cost analysis,
on which the JAX tool rests, counts the body of a layer scan once (the
Propagation, Inference and Refinement stacks are ``nn.scan``s), which
leaves 4 of each stage's 5 layers out of ``FLOPS.json``.  Elementwise
work, softmax and the bilinear sampling are not counted, on either path.

The kernels K1, K2 and B5 are the operators ``nmrf::window_attention``,
``nmrf::stripe_attention`` and ``nmrf::msda_taps`` (``ops/library.py``);
each has a flop formula here (``register_flop_formula``) that gives what
the counter counts on the operator's plain version at the same shapes, so a
count of the deployed forward sees inside the kernels and equals the
plain path's.  B5's plain version is elementwise (a hat-weighted tap sum):
its formula gives 0, as the counter gives its plain version.

The training step is counted at batch 1 and 2 (forward, backward and
AdamW, ``TPU.REMAT`` off: MFU counts useful FLOPs) and extrapolated to the
batch linearly, ``F(B) = F(1) + (B - 1) (F(2) - F(1))``.

Writes ``FLOPS_H100.json`` (the card's name and power limit, the peak, the
counts and, for each measured time folded in, the MFU).  The root's
``FLOPS.json`` is the JAX package's and is not touched.
"""

import argparse
import collections
import json
import os
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import (FlopCounterMode, flop_registry,
                                      register_flop_formula)

from ..ops import library

ROOT = Path(__file__).resolve().parents[2]
SWIN_CONFIG = ROOT / "configs" / "sceneflow_swint.yaml"

# NVIDIA's data sheet of the H100 SXM, dense rates at its 700 W limit
HBM_BYTES_PER_S = 3.35e12   # HBM3
BF16_OPS_PER_S = 989e12     # bf16 tensor-core peak
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
H100_PEAK_TFLOPS = BF16_OPS_PER_S / 1e12


# --------------------------------------------------------------------------- #
# flop formulas of the registered operators (2 FLOPs a multiply-add)
# --------------------------------------------------------------------------- #

def window_attention_flops(qkv_shape, window, num_heads):
    """FLOPs of one K1 call on qkv [B, Hp, Wp, N, 3C]: per window and head
    the T x T products q.k and a.v (T = P N tokens, P = wh ww pixels) and
    the three T x P positional and value-table products, ``G h hd (4 T^2 +
    6 T P)``."""
    B, Hp, Wp, N, C3 = qkv_shape
    wh, ww = window
    P = wh * ww
    T = P * N
    hd = C3 // 3 // num_heads
    G = B * (Hp // wh) * (Wp // ww)
    return G * num_heads * hd * (4 * T * T + 6 * T * P)


def stripe_attention_flops(q_shape, H_sp, W_sp, num_heads):
    """FLOPs of one K2 call on q [B, Hp, Wp, N, C]: q.k and a.v of every
    stripe of T = H_sp W_sp N tokens and head, ``4 T^2 hd`` each."""
    B, Hp, Wp, N, C = q_shape
    T = H_sp * W_sp * N
    stripes = B * (Hp // H_sp) * (Wp // W_sp)
    return stripes * num_heads * 4 * T * T * (C // num_heads)


def _register():
    """The formulas for the counter (once per process)."""
    library.register()  # defines the operators
    formulas = {
        torch.ops.nmrf.window_attention:
            lambda qkv, table, shift, window, heads, *a, out_shape=None, **kw:
            window_attention_flops(qkv, window, heads),
        torch.ops.nmrf.stripe_attention:
            lambda q, k, v, H_sp, W_sp, heads, *a, out_shape=None, **kw:
            stripe_attention_flops(q, H_sp, W_sp, heads),
        torch.ops.nmrf.msda_taps: lambda *a, out_shape=None, **kw: 0,
    }
    for op, formula in formulas.items():
        if op not in flop_registry:
            register_flop_formula(op)(formula)


_register()


# --------------------------------------------------------------------------- #
# roofline bounds of one launch: (bytes ms, operations ms)
# --------------------------------------------------------------------------- #

def msda_bound(B, Hq, Wq, f, M, P, D, esize):
    """(bytes ms, ops ms) of one B5 launch: dx, dy and aw (f32) and the
    level map read once, the output written once; per sample and corner one
    weight and D multiply-adds, in f32 on the CUDA cores."""
    samples = B * Hq * Wq * M * P
    nbytes = (3 * samples * 4 + B * (Hq // f) * (Wq // f) * M * D * esize
              + B * Hq * Wq * M * D * esize)
    ops = samples * 4 * (2 * D + 4)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3


def msda_bwd_bound(B, Hq, Wq, f, M, P, D, esize, corners):
    """(bytes ms, ops ms) of one B5b launch: the level map, dx, dy, aw (f32)
    and g read once, d value (value's dtype) and d dx, d dy, d aw (f32)
    written once; per kept corner the D-channel dot product with g, the
    hat weights and slopes and three products, and the D multiply-adds of
    d value, in f32 on the CUDA cores."""
    samples = B * Hq * Wq * M * P
    level = B * (Hq // f) * (Wq // f) * M * D * esize
    nbytes = 6 * samples * 4 + 2 * level + B * Hq * Wq * M * D * esize
    ops = corners * (4 * D + 16)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3


def window_bound(B, Hp, Wp, N, ws, C, heads, backward=False):
    """(bytes ms, ops ms) of one bf16 launch.  Forward: qkv read and the
    output written once, the f32 table read once; q.k, a.v, the two
    positional terms and the value-table term.  Backward: qkv and g read,
    d(qkv) written, the f32 table read and d(table) written once; the five
    T x T products (q.k and g.v recomputed, dq, dk, dv: 2.5x the forward's
    two) and eight T x P products (qr, kr and g.ve recomputed, the
    positional halves of dq and dk, the q, k and v table gradients).  That
    is the fully fused backward's (B7's) bound, which K1b's row shares: K1b
    also moves its f32 dqr, dkr and mass buffers ([G, h, T, P] each) out
    and back in, beyond it."""
    T, P = ws * ws * N, ws * ws
    nwin = B * (Hp // ws) * (Wp // ws)
    hd = C // heads
    tokens = B * Hp * Wp * N
    table = (2 * ws - 1) ** 2 * 3 * C * 4
    if backward:
        nbytes = tokens * (3 * C + C + 3 * C) * 2 + 2 * table
        ops = nwin * heads * (10 * T * T * hd + 16 * T * P * hd)
    else:
        nbytes = tokens * (3 * C + C) * 2 + table
        ops = window_attention_flops((B, Hp, Wp, N, 3 * C), (ws, ws), heads)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3


def stripe_bound(B, Hp, Wp, N, H_sp, W_sp, C, heads, backward=False):
    """(bytes ms, ops ms) of one bf16 launch: q, k, v (and g) read and the
    output (dq, dk, dv) written once; q.k and a.v of every stripe (the
    backward: five T x T products, 2.5x the forward's two)."""
    nbytes = B * Hp * Wp * N * (7 if backward else 4) * C * 2
    ops = stripe_attention_flops((B, Hp, Wp, N, C), H_sp, W_sp, heads)
    if backward:
        ops = ops * 10 // 4
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3


def masked_bound(G, Rq, Rk, heads, hd, Gm, backward=False):
    """(bytes ms, ops ms) of one bf16 launch: q, k, v (and g) and the f32
    mask read once, the output (dq, dk, dv) written once; q.k and a.v of
    every (group, head) (the backward: five Rq x Rk products)."""
    q_bytes, k_bytes = G * heads * Rq * hd * 2, G * heads * Rk * hd * 2
    mask_bytes = Gm * Rq * Rk * 4
    if backward:  # q, g, dq; k, v, dk, dv; the mask
        nbytes = 3 * q_bytes + 4 * k_bytes + mask_bytes
        ops = G * heads * 10 * Rq * Rk * hd
    else:
        nbytes = 2 * q_bytes + 2 * k_bytes + mask_bytes
        ops = G * heads * 4 * Rq * Rk * hd
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3


# --------------------------------------------------------------------------- #
# counts
# --------------------------------------------------------------------------- #

def make_cfg(config_file=None, golden=True, remat=False, opts=()):
    """The counted configuration (``tools/flops.py:make_cfg``): bf16, with
    ``golden`` the plain path (``TPU.USE_PALLAS False``,
    ``TPU.MSDA_TAP_RADIUS 0``), ``TPU.REMAT`` as given, crop 384x768, then
    the overrides ``opts``."""
    from ..config import get_cfg

    cfg = get_cfg()
    if config_file:
        cfg.merge_from_file(str(config_file))
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    if golden:
        cfg.TPU.USE_PALLAS = False
        cfg.TPU.MSDA_TAP_RADIUS = 0
    cfg.TPU.REMAT = remat
    cfg.DATASETS.CROP_SIZE = (384, 768)
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


def forward_flops(model, img1, img2, by_op=False):
    """FLOPs the counter counts over one eval forward of ``model`` (the
    operators' formulas included); with ``by_op`` also {op name: FLOPs}."""
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(img1, img2)
    total = counter.get_total_flops()
    if not by_op:
        return total
    return total, {str(op): n for op, n
                   in counter.get_flop_counts()["Global"].items()}


def count_inference(cfg, H, W, device=None):
    """(FLOPs, padded [Hp, Wp, 3]) of the eval forward at an H x W frame
    padded as the bench pads it (``InputPadder`` proposal mode to
    ``DATASETS.DIVIS_BY``), on ``cfg``'s path (the plain one from
    ``make_cfg(golden=True)``)."""
    from ..models import build_model
    from ..utils.benchmarks import kitti_inputs

    model = build_model(cfg, device=device)
    img1, img2 = kitti_inputs(cfg, next(model.parameters()).device, (H, W))
    return forward_flops(model, img1, img2), list(img1.shape[1:])


# ops that allocate, alias or read metadata: they move no tensor data
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "_unsafe_view",
               "lift_fresh", "_local_scalar_dense")


def tensor_bytes(t):
    """Bytes of the distinct elements a tensor addresses: a broadcast
    (stride 0) axis counts once, a view only its own elements."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n if t.numel() else 0


class BoundaryBytes(TorchDispatchMode):
    """Bytes read and written at every op boundary of the code run under it,
    the eager counterpart of XLA's fusion-boundary bytes: each op's input
    tensors read once and its outputs written once (an in-place op's tensor
    both), the ``nmrf`` operators as one op each.  Ops that return a view of
    their input (reshape, permute, slicing, ...) and the allocating and
    metadata ops of ``_NO_TRAFFIC`` move nothing and count 0.  ``bytes``:
    the total; ``by_op``: {op name: bytes}."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.by_op = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return out
        reads = [t for t in tree_leaves((args, {k: v for k, v in kwargs.items()
                                                if k != "out"}))
                 if isinstance(t, torch.Tensor)]
        writes = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        n = sum(tensor_bytes(t) for t in reads + writes)
        self.bytes += n
        self.by_op[str(func.overloadpacket)] += n
        return out


def forward_bytes(model, img1, img2):
    """(bytes, {op: bytes}) of one eval forward (:class:`BoundaryBytes`)."""
    with torch.inference_mode(), BoundaryBytes() as counter:
        model(img1, img2)
    return counter.bytes, dict(counter.by_op)


def zero_batch(B, H, W, device):
    return {"img1": torch.zeros((B, H, W, 3), device=device),
            "img2": torch.zeros((B, H, W, 3), device=device),
            "disp": torch.zeros((B, H, W), device=device),
            "valid": torch.ones((B, H, W), dtype=torch.bool, device=device)}


def count_train_step(cfg, B, device=None):
    """FLOPs of one training step (forward, criterion, backward, gradient
    clip and AdamW) at batch B and the config's crop."""
    from ..models import build_criterion, build_model
    from ..solver import build_optimizer, make_train_step

    model = build_model(cfg, device=device)
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           grad_clip=cfg.SOLVER.GRAD_CLIP)
    H, W = cfg.DATASETS.CROP_SIZE
    batch = zero_batch(B, H, W, next(model.parameters()).device)
    with FlopCounterMode(display=False) as counter:
        step(batch)
    return counter.get_total_flops()


def train_step_flops(cfg, B, device=None):
    """The step's count at batch B from the counts at batch 1 and 2:
    {"flops_b1", "flops_b2", "per_sample_flops", "batch_independent_flops",
    "flops_per_step"}."""
    f1 = count_train_step(cfg, 1, device)
    f2 = count_train_step(cfg, 2, device)
    return {"flops_b1": f1, "flops_b2": f2, "per_sample_flops": f2 - f1,
            "batch_independent_flops": 2 * f1 - f2,
            "flops_per_step": f1 + (B - 1) * (f2 - f1)}


def mfu(flops, ms, peak_tflops=H100_PEAK_TFLOPS):
    """Model FLOPs utilisation of ``flops`` done in ``ms``."""
    return flops / (ms / 1e3) / (peak_tflops * 1e12)


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #

def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for flag, what in (("--infer-ms", "resnet ms a KITTI frame"),
                       ("--swin-ms", "swin ms a KITTI frame"),
                       ("--train-ms", "ms a training step"),
                       ("--fused-train-ms", "ms a NMRF_FUSED_POS=1 step"),
                       ("--swin-train-ms", "ms a swin training step")):
        p.add_argument(flag, type=float, default=0.0,
                       help=f"measured {what} to fold in (0: none)")
    p.add_argument("--train-batch", type=int, default=8)
    p.add_argument("--peak-tflops", type=float, default=H100_PEAK_TFLOPS,
                   help="the card's dense bf16 peak (H100 SXM: 989)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out", default=str(ROOT / "FLOPS_H100.json"))
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="KEY VALUE config overrides of every counted config")
    return p


def main(argv=None):
    """Count, fold in the given times, write ``--out``; returns the record.
    The inference frame is KITTI's 375x1242 (``BENCH_HW`` overrides it)."""
    from ..models import resolve_device
    from ..utils.benchmarks import KITTI_HW, device_identity, parse_hw

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    H, W = parse_hw(os.environ["BENCH_HW"]) if os.environ.get("BENCH_HW") \
        else KITTI_HW
    peak = args.peak_tflops
    out = {"card": device_identity(device), "peak_flops_bf16": peak * 1e12,
           "count": "torch.utils.flop_counter on the plain path (USE_PALLAS "
                    "False, MSDA_TAP_RADIUS 0), every layer, 2 FLOPs a "
                    "multiply-add of each matmul and convolution"}
    for name, config_file, ms in (("resnet", None, args.infer_ms),
                                  ("swin", SWIN_CONFIG, args.swin_ms)):
        flops, shape = count_inference(
            make_cfg(config_file, golden=True, opts=args.opts), H, W, device)
        rec = {"frame": [H, W], "input": shape, "flops": flops}
        if ms > 0:
            rec["measured_ms"] = ms
            rec["mfu"] = mfu(flops, ms, peak)
        out[f"inference_{name}"] = rec
        print(f"inference {name}: {flops / 1e9:.3f} GFLOP a frame"
              + (f", MFU {rec['mfu'] * 100:.3f}% at {ms} ms" if ms > 0 else ""),
              flush=True)
    for name, config_file, timed in (
            ("resnet", None, {"default": args.train_ms,
                              "fused_pos": args.fused_train_ms}),
            ("swin", SWIN_CONFIG, {"default": args.swin_train_ms})):
        cfg = make_cfg(config_file, golden=True, remat=False, opts=args.opts)
        rec = {"crop": list(cfg.DATASETS.CROP_SIZE), "batch": args.train_batch,
               **train_step_flops(cfg, args.train_batch, device)}
        for variant, ms in timed.items():
            if ms > 0:
                rec[variant] = {"measured_ms_per_step": ms,
                                "mfu": mfu(rec["flops_per_step"], ms, peak)}
        out[f"train_step_{name}"] = rec
        print(f"train step {name}: B=1 {rec['flops_b1'] / 1e12:.4f} TFLOP, "
              f"B=2 {rec['flops_b2'] / 1e12:.4f}, B={args.train_batch} "
              f"{rec['flops_per_step'] / 1e12:.4f}" + "".join(
                  f"; {v} MFU {rec[v]['mfu'] * 100:.3f}% at "
                  f"{rec[v]['measured_ms_per_step']} ms"
                  for v in timed if v in rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out} ({out['card']})")
    return out


if __name__ == "__main__":
    main()
