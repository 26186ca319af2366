#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``nmrf_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. build every hand-written kernel from ``nmrf_tpu_torch/csrc`` (one nvcc per
   source, in parallel) into ``nmrf_tpu_torch/_build``;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, in float32 (TF32 off) and bfloat16;
3. drive the main path: the default-config resnet model at full width and
   depth (bf16, tanh GELU, random seeded weights) answers KITTI-size
   375x1242 requests through ``predict``, with every launch counter read
   around the requests; then one float32 full-size forward through the
   kernels is held against the same forward on the kernels' plain versions;
4. time each kernel beside its plain version, its bound and one PyTorch
   library call (``scaled_dot_product_attention``) at the same shapes, and
   break a request down by device kernel with ``torch.profiler``.

It imports nothing of JAX or of ``nmrf_tpu``.  The last stdout line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np

H_KITTI, W_KITTI = 375, 1242
REQUESTS = 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
# kernel vs plain version on identical inputs: f32 differs only by summation
# order; bf16 adds one rounding of the output to bf16 (8 significant bits)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}  # (atol, rtol)

REPLACES = {
    "window_attention": "nmrf_tpu/ops/pallas/attention.py:674",
    "stripe_attention": "nmrf_tpu/ops/pallas/attention.py:202",
}


def log(*args):
    print(*args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of fn() over iters calls, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# kernel cases at the main path's shapes (KITTI 375x1242 padded to 376x1248)
# --------------------------------------------------------------------------- #

# (label, Hp, Wp, N, ws, shift, candidate_mask, layers per frame)
WINDOW_CASES = [
    ("inference/shift0", 48, 156, 4, 6, 0, True, 3),
    ("inference/shift3", 48, 156, 4, 6, 3, True, 2),
    ("refinement/shift0", 96, 312, 1, 4, 0, False, 3),
    ("refinement/shift2", 96, 312, 1, 4, 2, False, 2),
]
# (label, Hp, Wp, N, H_sp, W_sp, layers per frame); CSWin half: 64 ch, 2 heads
STRIPE_CASES = [
    ("vertical/T188", 47, 156, 4, 47, 1, 5),
    ("horizontal/T624", 47, 156, 4, 1, 156, 5),
]


def window_bound(Hp, Wp, N, ws, C, heads):
    """(bytes ms, ops ms) of one bf16 launch: qkv read and output written
    once, the f32 table read once; q.k, a.v, the two positional terms and
    the value-table term."""
    T, P = ws * ws * N, ws * ws
    nwin = (Hp // ws) * (Wp // ws)
    hd = C // heads
    nbytes = Hp * Wp * N * (3 * C + C) * 2 + (2 * ws - 1) ** 2 * 3 * C * 4
    ops = nwin * heads * (4 * T * T * hd + 6 * T * P * hd)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3


def stripe_bound(Hp, Wp, N, H_sp, W_sp, C, heads):
    """(bytes ms, ops ms) of one bf16 launch: q, k, v read and the output
    written once; q.k and a.v of every stripe."""
    T = H_sp * W_sp * N
    nstripes = (Hp // H_sp) * (Wp // W_sp)
    nbytes = Hp * Wp * N * 4 * C * 2
    ops = nstripes * heads * 4 * T * T * (C // heads)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3


def check_close(name, got, want, dtype_name):
    import torch

    atol, rtol = TOL[dtype_name]
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    excess = (err - rtol * want.abs()).max().item()
    if excess > atol:
        fail(f"{name} [{dtype_name}]: kernel disagrees with its plain version "
             f"(max abs err {err.max().item():.3e}, atol {atol}, rtol {rtol})")
    return err.max().item()


def kernel_phase(gen):
    """Phase 2 and the kernel timings of phase 4."""
    import torch
    import torch.nn.functional as F

    from nmrf_tpu_torch.ops import attention as A

    dev = "cuda"
    results = {"window_attention": [], "stripe_attention": []}
    C, heads = 128, 4
    for label, Hp, Wp, N, ws, shift, cand, per_frame in WINDOW_CASES:
        qkv32 = torch.randn(1, Hp, Wp, N, 3 * C, generator=gen, device=dev)
        table = 0.5 * torch.randn((2 * ws - 1) ** 2, 3 * C, generator=gen,
                                  device=dev)
        entry = {"shape": label, "per_frame": per_frame}
        for dtype_name, dt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
            qkv = qkv32.to(dt)
            got = A.window_attention(qkv, table, shift, (ws, ws), heads, cand)
            torch.cuda.synchronize()
            want = A.window_attention_plain(qkv, table, shift, (ws, ws), heads,
                                            cand)
            entry[f"max_abs_err_{dtype_name}"] = check_close(
                f"window_attention {label}", got, want, dtype_name)
        # timings in the main path's dtype (bf16)
        qkv = qkv32.to(torch.bfloat16)
        entry["ms"] = cuda_ms(lambda: A.window_attention(
            qkv, table, shift, (ws, ws), heads, cand), 20)
        entry["plain_ms"] = cuda_ms(lambda: A.window_attention_plain(
            qkv, table, shift, (ws, ws), heads, cand), 5)
        # library yardstick: SDPA with the positional logits and masks folded
        # into an additive [G, h, T, T] mask (it lacks the value-table term)
        T, hd = ws * ws * N, C // heads
        G = (Hp // ws) * (Wp // ws)
        qs, ks, vs = (torch.randn(G, heads, T, hd, generator=gen, device=dev,
                                  dtype=torch.bfloat16) for _ in range(3))
        bias = torch.randn(G, heads, T, T, generator=gen, device=dev,
                           dtype=torch.bfloat16)
        entry["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias), 20)
        bytes_ms, ops_ms = window_bound(Hp, Wp, N, ws, C, heads)
        entry["bytes_ms"], entry["ops_ms"] = bytes_ms, ops_ms
        results["window_attention"].append(entry)
        log(f"kernel window_attention {label}: " + json.dumps(entry))

    C, heads = 64, 2
    for label, Hp, Wp, N, H_sp, W_sp, per_frame in STRIPE_CASES:
        qkv32 = [torch.randn(1, Hp, Wp, N, C, generator=gen, device=dev)
                 for _ in range(3)]
        entry = {"shape": label, "per_frame": per_frame}
        for dtype_name, dt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
            q, k, v = (t.to(dt) for t in qkv32)
            got = A.stripe_attention(q, k, v, H_sp, W_sp, heads)
            torch.cuda.synchronize()
            want = A.stripe_attention_plain(q, k, v, H_sp, W_sp, heads)
            entry[f"max_abs_err_{dtype_name}"] = check_close(
                f"stripe_attention {label}", got, want, dtype_name)
        q, k, v = (t.to(torch.bfloat16) for t in qkv32)
        entry["ms"] = cuda_ms(lambda: A.stripe_attention(q, k, v, H_sp, W_sp,
                                                         heads), 20)
        entry["plain_ms"] = cuda_ms(lambda: A.stripe_attention_plain(
            q, k, v, H_sp, W_sp, heads), 5)
        T, hd = H_sp * W_sp * N, C // heads
        G = (Hp // H_sp) * (Wp // W_sp)
        qs, ks, vs = (torch.randn(G, heads, T, hd, generator=gen, device=dev,
                                  dtype=torch.bfloat16) for _ in range(3))
        mask = torch.as_tensor(A.stripe_mask(T, N), device=dev).to(torch.bfloat16)
        entry["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask), 20)
        bytes_ms, ops_ms = stripe_bound(Hp, Wp, N, H_sp, W_sp, C, heads)
        entry["bytes_ms"], entry["ops_ms"] = bytes_ms, ops_ms
        results["stripe_attention"].append(entry)
        log(f"kernel stripe_attention {label}: " + json.dumps(entry))
    return results


# --------------------------------------------------------------------------- #
# main path
# --------------------------------------------------------------------------- #

def main_path_cfg(dtype, gelu_approx, use_kernels):
    from nmrf_tpu_torch.config import get_cfg

    cfg = get_cfg()  # default config: resnet, 5 + 5 + 5 NMP layers
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TPU.GELU_APPROX = gelu_approx
    cfg.TPU.USE_PALLAS = use_kernels
    cfg.freeze()
    return cfg


def serve_phase():
    """Phase 3a: requests through predict; returns timings and counts."""
    import torch

    from nmrf_tpu_torch import build_model, predict
    from nmrf_tpu_torch.ops import attention as A

    model = build_model(main_path_cfg("bfloat16", True, True))
    rng = np.random.RandomState(0)
    pairs = [((rng.rand(H_KITTI, W_KITTI, 3) * 255).astype(np.float32),
              (rng.rand(H_KITTI, W_KITTI, 3) * 255).astype(np.float32))
             for _ in range(REQUESTS + 1)]
    t0 = time.perf_counter()
    predict(model, *pairs[0])  # warm-up: cuDNN plans, first kernel launches
    warmup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host_ms, disps = [], []
    start.record()
    for img1, img2 in pairs[1:]:
        t = time.perf_counter()
        disps.append(predict(model, img1, img2))
        host_ms.append((time.perf_counter() - t) * 1e3)
    end.record()
    torch.cuda.synchronize()
    counts = A.launch_counts()
    frame_ms = start.elapsed_time(end) / REQUESTS

    for d in disps:
        if d.shape != (H_KITTI, W_KITTI):
            fail(f"disparity shape {d.shape}")
        if not np.isfinite(d).all() or (d < 0).any():
            fail("disparity not finite and non-negative")
    for name, n in counts.items():
        if n != 10 * REQUESTS:
            fail(f"{name}: {n} launches over {REQUESTS} requests, "
                 f"expected {10 * REQUESTS}")
    return model, pairs[1], {
        "requests": REQUESTS, "frame_ms": frame_ms, "host_request_ms": host_ms,
        "warmup_s": warmup_s, "launches": counts,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "disp_mean": float(np.mean([d.mean() for d in disps]))}


KERNEL_GROUPS = (
    ("window_attention (K1)", ("window_attention_kernel",)),
    ("stripe_attention (K2)", ("stripe_attention_kernel",)),
    ("convolution", ("conv", "fprop", "cudnn", "implicit", "winograd")),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas")),
    ("memcpy", ("Memcpy", "Memset")),
    ("layer_norm", ("layer_norm",)),
    ("reduction", ("reduce_kernel",)),
    ("copy/cast", ("copy", "cast")),
    ("sort/index", ("sort", "gather", "index", "scatter", "argmax")),
)


def profile_phase(model, pair):
    """Phase 4b: one request under torch.profiler; device time by kernel
    group, and the device's busy share of the request's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nmrf_tpu_torch import predict

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict(model, *pair)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, spans = {}, []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        spans.append((evt.time_range.start, evt.time_range.end))
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in evt.name for k in keys)), "other elementwise")
        total, count = groups.get(group, (0.0, 0))
        groups[group] = (total + us, count + 1)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # union of device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    rows = sorted(((t / 1e3, c, g) for g, (t, c) in groups.items()), reverse=True)
    for ms, count, group in rows:
        log(f"profile: {ms:9.3f} ms  x{count:<5d} {group}")
    if not spans:
        fail("profiler recorded no device activity")
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
            "groups": [{"group": g, "ms": ms, "launches": c} for ms, c, g in rows]}


def parity_phase():
    """Phase 3b: float32 full-size forward, kernels vs plain versions."""
    import torch
    import torch.nn.functional as F

    from nmrf_tpu_torch import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern = build_model(main_path_cfg("float32", False, True))
    plain = build_model(main_path_cfg("float32", False, False))
    plain.load_state_dict(kern.state_dict())
    rng = np.random.RandomState(1)
    Hp, Wp = 376, 1248  # InputPadder "proposal" size of 375x1242
    img1, img2 = (torch.from_numpy((rng.rand(1, Hp, Wp, 3) * 255).astype(
        np.float32)).cuda() for _ in range(2))
    scores = {}

    def grab(name):
        def hook(_module, _inputs, output):
            scores[name] = output
        return hook

    outs = {}
    for name, model in (("kernels", kern), ("plain", plain)):
        handle = model.infer_score_head.register_forward_hook(grab(name))
        with torch.inference_mode():
            outs[name] = model(img1, img2)
        handle.remove()
    got, ref = outs["kernels"], outs["plain"]
    torch.cuda.synchronize()

    def err(k):
        return (got[k].float() - ref[k].float()).abs().max().item()

    # continuous outputs: strict (tolerances of the JAX package's full-model
    # parity test)
    for key, atol, rtol in (("prob", 2e-4, 1e-3), ("initial_proposal", 1e-3, 0),
                            ("proposal", 1e-3, 0)):
        torch.testing.assert_close(got[key].float(), ref[key].float(),
                                   atol=atol, rtol=rtol)
    # selection-dependent disparity: every mismatch must lie within the
    # refinement receptive field (96 px) of a top-2 logit near-tie
    logits = scores["plain"][-1]  # [B, h8, w8, N, 64]
    B, h8, w8, N, _ = logits.shape
    logits = logits.reshape(B, h8, w8, N, 8, 8).permute(0, 1, 4, 2, 5, 3)
    logits = logits.reshape(B, h8 * 8, w8 * 8, N)
    top2 = logits.topk(2, dim=-1).values
    near_tie = ((top2[..., 0] - top2[..., 1]) < 1e-5).float()
    tie_region = F.max_pool2d(near_tie[:, None], 2 * 96 + 1, 1, 96)[:, 0] > 0
    bad = (got["disp"] - ref["disp"]).abs() > 4e-3
    if bad[~tie_region].any():
        fail(f"{int(bad[~tie_region].sum())} disparity mismatches outside any "
             "near-tie region (kernels vs plain versions, f32)")
    if bad.float().mean().item() >= 0.10:
        fail(f"disparity mismatch fraction {bad.float().mean().item():.3f}")
    return {"prob_err": err("prob"), "proposal_err": err("proposal"),
            "initial_proposal_err": err("initial_proposal"),
            "disp_err": err("disp"), "disp_mismatch_frac": bad.float().mean().item(),
            "near_tie_px": int(near_tie.sum().item())}


def kernels_line(kernel_results, counts):
    line = []
    for name, entries in kernel_results.items():
        agg = {k: sum(e[k] * e["per_frame"] for e in entries)
               for k in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
        line.append({
            "name": name, "route": "cuda",
            "source": f"nmrf_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": counts[name],
            "max_abs_err": max(e["max_abs_err_bfloat16"] for e in entries),
            "max_abs_err_f32": max(e["max_abs_err_float32"] for e in entries),
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": sum(max(e["bytes_ms"], e["ops_ms"]) * e["per_frame"]
                            for e in entries),
            "bound_by": "bytes" if agg["bytes_ms"] >= agg["ops_ms"] else "operations",
            "library_ms": agg["library_ms"],
            "unit": "per frame: the 10 launches of one KITTI request, bf16",
            "shapes": entries,
        })
    return {"kernels": line}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from nmrf_tpu_torch.ops import _native

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    report = _native.build_all()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s for "
        f"{len(report)} kernels (nvcc in parallel)")
    for name, (secs, text) in report.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"  {name}: {secs:.1f} s; " + " | ".join(regs))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        kernel_results = kernel_phase(gen)
    log("phase 2 kernels: every kernel matches its plain version "
        "(f32 and bf16)")

    model, pair, serve = serve_phase()
    log("phase 3 main path: " + json.dumps(serve))
    parity = parity_phase()
    log("phase 3 f32 kernels vs plain versions: " + json.dumps(parity))
    breakdown = profile_phase(model, pair)
    log("phase 4 breakdown: " + json.dumps(breakdown))

    log(gpu_identity())
    log(json.dumps(kernels_line(kernel_results, serve["launches"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
