#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``nmrf_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded-only --grid 2 2 --backend nccl  # 4 cards
    python3 chip_smoke.py --compare-old DIR  # K1/B5/B5b vs DIR's sources
    python3 chip_smoke.py --k1-stages        # K1's time by stage
    python3 chip_smoke.py --entry-only       # phase 8 alone
    python3 chip_smoke.py --serve-only       # phase 9 alone
    python3 chip_smoke.py --bench-only       # phase 10 alone

Phases (any failure exits non-zero before the last line is printed):

1. build every hand-written kernel from ``nmrf_tpu_torch/csrc`` (one nvcc per
   source, in parallel) into ``nmrf_tpu_torch/_build``; the tensor-core
   kernels must not spill registers at head dim 32 (``NO_SPILL``);
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes, in float32 (TF32 off) and bfloat16: the forward
   kernels K1 and K2 at the KITTI serving shapes (both also at the
   training shapes, bf16 at the training batch; K2 on a sharded rank's
   tile), the
   backward kernels K1b, K2b and B7 (the fully fused window backward of
   the NMRF_FUSED_POS=1 training path) at the training shapes (batch 1,
   and bf16 at the training batch of 8) and the KITTI shapes; B7 also against K1b on the
   same f32 inputs (the same function), and two launches of K1b, K2b or B7
   on the same inputs must give the same bits;
   The tap-MSDA kernel B5 is held against its plain version at the four
   extractor shapes of a swin KITTI request, and once with samples beyond
   its radius and past the borders; its backward B5b at the four extractor
   shapes of a swin training step (batch 16, the left and right images of
   8 pairs), also beyond the radius and past the borders, each launch on
   its vector path with the tap masks, and against a second launch (same
   bits), and timed by kernel (sample, cell masks, value); and B5 and B5b
   at a rank's H tile (query rows from q0, the level map's rows from v0
   with its halo rows, ``MSDA_TILE_CASES``: a 1 x 2 sharded swin step's 4
   levels, a halo past the top edge, and q0 12 at f 8, not a multiple of
   f), B5b also against a second launch, the rank's 4 launches timed;
3. drive the serving paths: the default-config resnet model and the swin
   model (``configs/sceneflow_swint.yaml``: Swin-T and the deformable neck),
   each at full width and depth (bf16, tanh GELU, random seeded weights),
   answer KITTI-size 375x1242 requests through ``predict``, with every
   launch counter read around each model's requests; then, for each model,
   one float32 full-size forward through the kernels is held against the
   same forward on the kernels' plain versions;
4. hold the float32 gradients of the Propagation, Inference and Refinement
   stages (full width, training shape, batch 1) through the kernels against
   the same stages on the plain versions, and those of the Inference and
   Refinement stages again with NMRF_FUSED_POS=1 (K1 and B7); then the
   float32 parameter gradients of the swin backbone and deformable neck
   (training crop, one pair, drop-path on with the same masks on both
   sides) through B5 and B5b against the plain versions;
5. drive the training path: the default-config model at full width and
   depth (bf16) takes one warm-up and 10 timed training steps at crop
   384x768, batch 8, on a fixed batch of synthetic pairs (disparities up to
   192 on whole 1/8-resolution bins), with every launch counter read around
   the timed steps, and its loss must fall; then the same config, batch
   and seed again with NMRF_FUSED_POS=1 (B7 in place of K1b), its step
   time and peak memory beside the first run's; then the swin model
   (``configs/sceneflow_swint.yaml``: drop-path 0.4, tap radius 5) takes
   1 + 30 steps on the same kind of batch with the tap-path monitor on
   (``msda_tap_oob`` reported, 0 at init), 4 B5 and 4 B5b launches a step
   (their vector kernels, B5b with its tap masks) beside the NMP stages'
   10 of each;
6. time each kernel beside its plain version, its bound and one PyTorch
   library call (``scaled_dot_product_attention``, its backward for K1b,
   B7, K2b and B6b; ``grid_sample`` for B5 and its backward for B5b) at
   the same shapes (B5b on uniform displacements, and again on the
   samples of its 4 launches in a swin training step with the level map
   and g drawn N(0, 1), also checked there against its plain version; K1b
   also
   by kernel: its main kernel, its d(ve) kernels and the plain products of
   ``_window_bwd_finish``; B7 its main kernel and its partial sum), and
   break a request of each model, a training step, a NMRF_FUSED_POS=1
   training step and a swin training step down by device kernel with
   ``torch.profiler``;
7. drive the H-sharded path: two processes on the one card (a 1 x 2
   (data, spatial) grid over gloo, ``nmrf_tpu_torch.parallel``) serve 4
   KITTI pairs padded to 384x1248 through ``make_sharded_forward`` (bf16,
   tanh GELU), hold the f32 sharded forward against the unsharded one, hold
   the gradients of one f32 sharded step against the unsharded step's
   (crop 384x768, batch 8), and take 1 + 1 + 5 sharded training steps
   (warm-up, profiled, timed; bf16), then 1 + 1 + 5 more with
   NMRF_FUSED_POS=1 (B7 in place of K1b), with the launch counters of each
   rank read around the timed requests and steps; rank 0 profiles a request
   and a step.  Phase 2 also holds the rectangular masked attention B6
   and its backward B6b (at the sharded serving and training shapes, G 156
   and 768, and on a ragged shape; two B6b launches give the same bits),
   and K1/K1b/B7 at a tile's row offset, against their plain versions.
   Each rank's resnet backbone runs on its H tile (the stem's input must
   hold the tile's rows, not the image's), and its part of a sharded step
   (forward and backward, bf16, batch 8) is timed and profiled against the
   same on the whole images with the tile kept.  The swin model on the
   same grid: 2 KITTI pairs padded to 384x1248 through
   ``make_sharded_forward`` in f32, each held on rank 0 against the
   unsharded swin forward (4 B5 + 10 K1 + 5 K2 + 5 B6 a frame per rank);
   one f32 sharded swin step (batch 2, drop-path on, the same masks on
   both sides) against the unsharded step, losses and every gradient leaf;
   then 1 + 3 sharded swin steps (bf16, batch 8, the tap monitor on: 4 B5
   and 4 B5b a step per rank beside the decode's launches), every rank with
   the same losses, ``msda_tap_oob`` (0 at init) and parameters; each
   rank's B5/B5b launches are logged.  Each rank's swin backbone runs on
   its H tile (Swin-T's windows completed from the neighbour tiles, stages
   too short for a tile whole, the neck's value maps exchanged for the
   rows its taps reach): in f32 its features and spatially summed
   gradients are held against the whole images' with the tile kept, its
   stem and patch embedding must take the tile's rows, and in bf16 (batch
   8) its forward and backward are timed (CUDA events, peak memory, a
   profile's busy ms) beside the whole-image form's.
   Then two ranks on the card over gloo on a 2 x 1 grid (the data axis)
   take 2 swin training steps of 4 pairs each (drop-path masks: rows of
   one global draw; the tap monitor's shares averaged over the ranks):
   both ranks must report the same losses and ``msda_tap_oob`` and keep
   the same parameters, with 4 B5 and 4 B5b launches a step per rank.
   Last, ``python -m nmrf_tpu_torch.bench_scaling --ranks 2`` (phase 7c):
   the weak-scaling points (1, 1), (2, 1) and (1, 2) on the card, each
   held to the port's communication contract, the record written with
   ``--out`` to a temporary file, efficiency null where ranks share the
   card.

8. drive the training and evaluation entry point,
   ``nmrf_tpu_torch.train.main`` (the CLI), in this process at full width
   (default config, bf16, batch 8, 384x768 pairs of
   ``synthetic_16x384x768``, every run deterministic): 6 steps with
   checkpoints at 3 and 6; a copy of step 3 resumed to 6 must save the
   same model and AdamW state bit for bit; a resume of step 6 to 9 with
   ``CHECKPOINT_PERIOD 100`` continues the step count and leaves only step
   9; ``--eval-only`` evaluates the last checkpoint on 2 KITTI-size pairs
   (padded to 376x1248, bucketed) with a finite EPE; K1, K2, K1b and K2b
   launch 10 times a step (K1 and K2 10 times a frame); and the host
   photometric kernel (``nmrf_tpu_torch/native``) matches its PIL version
   on a 375x1242 image (skipped, with a logged line, where PIL is absent);
   then the convergence-gate diagnostics through their ``main``:
   ``tools.probe_costvolume_signal`` (one seed of each kind, 192x384,
   bf16) and ``tools.debug_convergence`` (the default config's overfit
   probe at its recipe, 20 steps): their lines parse with finite numbers,
   and the overfit probe launches K1, K2, K1b and K2b as its steps and
   evaluations take.

9. drive the serving entry points with each model of phase 3 (bf16, tanh
   GELU, random seeded weights): export the frozen eval forward with
   ``nmrf_tpu_torch/tools/export_serving.py``'s code at the padded KITTI
   shape (376x1248 resnet, 384x1248 swin), save and load it again; its
   graph must hold 10 ``nmrf.window_attention``, 10
   ``nmrf.stripe_attention`` and 0 or 4 ``nmrf.msda_taps`` nodes (the
   registered operators of ``ops/library.py``); serve 4 KITTI-size pairs
   over HTTP (``tools/serve_http.py`` on 127.0.0.1 in a thread), each
   answer [375, 1242], finite, non-negative and equal to the live
   ``predict`` of the pair (bit for bit, or within 1e-3 px outside the
   reach of an argmax near-tie), 40 K1 and 40 K2 launches (16 B5 for
   swin) over the 4 requests; time the client's wall, the server's
   ``X-Timing-Ms`` split and the artifact's call (CUDA events, and one
   profiled call); write a KITTI_2015 submission of 2 of the pairs through
   ``python -m nmrf_tpu_torch.inference``'s ``main`` and hold the PNGs
   against ``predict`` within the 1/256 encoding; render the ``--input``
   demo where matplotlib is installed (else a logged line); then time the
   host cost of a call of each operator against its launch function.

With ``--compare-old DIR`` it builds the kernels and those of DIR's
``window_attention.cu``, ``msda_taps.cu`` and ``msda_taps_bwd.cu`` that
it holds (earlier versions of K1, B5 and B5b, with DIR's headers) and
times the two versions in turns (old, new, new, old): K1 at the KITTI
windows (batch 1) and the training windows (batch 8), B5 at the four
extractor shapes of a swin KITTI request, B5b at the four of a swin
training step, each beside SDPA (K1), ``grid_sample`` (B5) or its
backward (B5b) and the bound, then the training steps that run them (the
default and the NMRF_FUSED_POS=1 steps for K1, the swin step for B5 and
B5b); nothing else runs.  With
``--k1-stages`` it builds K1's source with one stage of its tensor-core
kernel cut out at a time and times each beside the whole kernel, at a
KITTI and a training window of Inference and Refinement (``K1_CUTS``).

10. drive the measurement entry points in this process at full width,
   each through its ``main`` with its stdout captured and checked and the
   launch counters read around it: ``python -m nmrf_tpu_torch.bench``
   for the resnet and the swin model (``--repeat 3``: JSON keys and
   metric names the JAX bench's; 480 K1 and 480 K2 launches in the timed
   chains, 192 B5 for swin; the deployed forward's FLOP count, with the
   operators' flop formulas, within 1% of the plain path's; a profile
   whose groups name K1 and K2), ``nmrf_tpu_torch.bench_train`` for the
   default model, again with NMRF_FUSED_POS=1, and for swin (384x768,
   batch 8, bf16: finite loss, MFU in (0, 1), the launches a step of
   phase 5), ``tools.bench_stages``, ``tools.bench_swin_parts``,
   ``tools.profile_model``, ``tools.profile_train``, ``tools.bench_loader``,
   ``tools.bench_photometric``, ``tools.check_tap_coverage`` (the swin
   model at 375x1242: exit 0) and ``tools.flops``, which writes the
   ``FLOPS_H100.json`` record with the phase's times folded in (kept only
   with ``--flops-out PATH``); the kernels' bound operation counts (the
   bounds' ``ops_ms`` times the peak, not measured) and their shares of the
   frame's and step's FLOPs.  ``--bench-only`` runs this phase alone.

It imports nothing of JAX or of ``nmrf_tpu``.  The last stdout line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from nmrf_tpu_torch.tools.flops import (BF16_OPS_PER_S, F32_OPS_PER_S,
                                        masked_bound, msda_bound,
                                        msda_bwd_bound, stripe_bound,
                                        window_bound)
# the window backwards' own kernels by name: K1b's main and d(ve) kernels
# (the rest of a launch's device time is the plain products of
# ``_window_bwd_finish``), B7's main kernel and its in-order partial sum;
# the union of intervals
from nmrf_tpu_torch.tools.profile_model import (B7_MAIN, B7_SUM, K1B_DVE,
                                                K1B_MAIN, _union_ms)
from nmrf_tpu_torch.utils.benchmarks import gpu_identity

H_KITTI, W_KITTI = 375, 1242
REQUESTS = 4
TRAIN_STEPS = 10
# the swin step's loss rises over its first 5-7 steps at this recipe and
# batch (through the kernels, the plain versions and in f32 alike) and falls
# after: its falling-loss test takes a window that covers that
SWIN_TRAIN_STEPS = 30
# kernel vs plain version on identical inputs: f32 differs only by summation
# order; bf16 adds one rounding of the output to bf16 (8 significant bits).
# The backward kernels' bf16 d(q, k, v) sum up to T (at most 624) products
# of bf16-rounded inputs of magnitude about 1 before that rounding, where
# the plain version sums the same products in another order: atol 5e-2.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}  # (atol, rtol)
TOL_BWD = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}

REPLACES = {
    "window_attention": "nmrf_tpu/ops/pallas/attention.py:674",
    "stripe_attention": "nmrf_tpu/ops/pallas/attention.py:202",
    "window_attention_bwd": "nmrf_tpu/ops/pallas/attention.py:1258",
    "stripe_attention_bwd": "nmrf_tpu/ops/pallas/attention.py:329",
    "msda_taps": "nmrf_tpu/ops/pallas/msda.py:93",
    "masked_attention": "nmrf_tpu/ops/pallas/attention.py:59",
    "masked_attention_bwd": "nmrf_tpu/ops/pallas/attention.py:135",
    "window_attention_pos_bwd": "nmrf_tpu/ops/pallas/attention.py:1210",
    # not a pallas_call: the JAX package's jnp backward of B5 (_tap_bwd)
    "msda_taps_bwd": "nmrf_tpu/ops/msda.py:163",
}


def log(*args):
    print(*args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


@contextlib.contextmanager
def fused_pos():
    """NMRF_FUSED_POS=1 inside the block: the window layers' backward is B7
    instead of K1b (``main`` clears the variable at the start)."""
    os.environ["NMRF_FUSED_POS"] = "1"
    try:
        yield
    finally:
        del os.environ["NMRF_FUSED_POS"]


def ptxas_kernels(text):
    """[(kernel, registers, spill-store bytes)] from ``nvcc -Xptxas -v``;
    a kernel is its name and template arguments (bf16/f32, integers)."""
    import re

    out, name, spills = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            n = re.match(r"_ZN4nmrf(\d+)", mangled)
            if n:
                start = n.end()
                base = mangled[start:start + int(n.group(1))]
                rest = mangled[start + int(n.group(1)):]
                args = (["bf16"] if "bfloat16" in rest else ["f32"] if rest.startswith("IfL") else []) \
                    + re.findall(r"Li(\d+)E", rest)
                name = f"{base}<{','.join(args)}>" if args else base
            else:
                name = mangled
            spills = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spills))
            name = None
    return out


# the tensor-core kernels at the main paths' head dim (32), and B5's and
# B5b's vector-path kernels at the swin neck's (bf16, D 8): each must build
# without spilling
# registers to local memory
NO_SPILL = {
    "stripe_attention": ("stripe_attention_mma_kernel<bf16,32>",),
    "stripe_attention_bwd": ("stripe_bwd_dq_mma_kernel<bf16,32>",
                             "stripe_bwd_dkv_mma_kernel<bf16,32>"),
    "window_attention_bwd": ("window_bwd_mma_kernel<bf16,32,1>",
                             "window_bwd_mma_kernel<bf16,32,9>"),
    "window_attention_pos_bwd": ("window_pos_bwd_mma_kernel<bf16,32,1>",
                                 "window_pos_bwd_mma_kernel<bf16,32,9>"),
    "masked_attention": ("masked_attention_mma_kernel<bf16,32>",),
    "masked_attention_bwd": ("masked_bwd_dq_mma_kernel<bf16,32>",
                             "masked_bwd_dkv_mma_kernel<bf16,32>"),
    "window_attention": ("window_attention_mma_kernel<bf16,32,1>",
                         "window_attention_mma_kernel<bf16,32,9>"),
    "msda_taps": ("msda_taps_vec_kernel<bf16,8>",),
    "msda_taps_bwd": ("msda_bwd_sample_kernel<bf16,8,1>",
                      "msda_bwd_cell_mask_kernel",
                      "msda_bwd_gather_kernel<bf16,8>",
                      "msda_bwd_sample_kernel<bf16,8,0>",
                      "msda_bwd_walk_kernel<bf16,8>"),
}


def check_spills(report):
    """Fail if ptxas reported a spill, or no report, for a kernel of
    NO_SPILL in a library that this run built."""
    for lib, kernels in NO_SPILL.items():
        if lib not in report:
            continue
        found = {fn: spills for fn, _, spills in ptxas_kernels(report[lib][1])}
        for kernel in kernels:
            if kernel not in found:
                fail(f"ptxas reported nothing for {kernel} ({lib}.cu)")
            if found[kernel]:
                fail(f"{kernel} spills {found[kernel]} B of registers")


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
# kernel cases at the main paths' shapes
# --------------------------------------------------------------------------- #

# serving (KITTI 375x1242 padded to 376x1248), batch 1:
# (label, Hp, Wp, N, ws, shift, candidate_mask, launches per frame)
WINDOW_CASES = [
    ("inference/shift0", 48, 156, 4, 6, 0, True, 3),
    ("inference/shift3", 48, 156, 4, 6, 3, True, 2),
    ("refinement/shift0", 96, 312, 1, 4, 0, False, 3),
    ("refinement/shift2", 96, 312, 1, 4, 2, False, 2),
]
# (label, Hp, Wp, N, H_sp, W_sp, launches per frame); CSWin half: 64 ch, 2 heads
STRIPE_CASES = [
    ("vertical/T188", 47, 156, 4, 47, 1, 5),
    ("horizontal/T624", 47, 156, 4, 1, 156, 5),
]
# training (crop 384x768: 48x96 at 1/8, 96x192 at 1/4), checked at batch 1
# and at batch TRAIN_BATCH, timed at TRAIN_BATCH; the last field is
# launches per step
TRAIN_BATCH = 8
TRAIN_WINDOW_CASES = [
    ("train inference/shift0", 48, 96, 4, 6, 0, True, 3),
    ("train inference/shift3", 48, 96, 4, 6, 3, True, 2),
    ("train refinement/shift0", 96, 192, 1, 4, 0, False, 3),
    ("train refinement/shift2", 96, 192, 1, 4, 2, False, 2),
]
TRAIN_STRIPE_CASES = [
    ("train vertical/T192", 48, 96, 4, 48, 1, 5),
    ("train horizontal/T384", 48, 96, 4, 1, 96, 5),
]


# swin serving (KITTI 375x1242 padded to 384x1248 by DIVIS_BY 32): the
# DeformNeck's query grid is 96 x 312 at batch 2 (left and right images);
# one B5 launch per extractor, over its level at factor f.
# (label, f, launches per frame, sample spread in level pixels)
MSDA_R, MSDA_HEADS, MSDA_POINTS, MSDA_HEAD_DIM = 5, 8, 4, 8
MSDA_Q = (96, 312)
MSDA_CASES = [
    ("extractor0/f1", 1, 1, MSDA_R),
    ("extractor1/f2", 2, 1, MSDA_R),
    ("extractor2/f4", 4, 1, MSDA_R),
    ("extractor3/f8", 8, 1, MSDA_R),
    ("f8, beyond r and past the borders", 8, 0, MSDA_R + 3),
    ("f1, beyond r and past the borders", 1, 0, MSDA_R + 3),
]


# swin training (crop 384x768, batch 8): the neck's query grid is 96 x 192
# at batch 16 (left and right images); one B5b launch per extractor and step.
# (label, f, launches per step, sample spread in level pixels)
MSDA_TRAIN_Q = (96, 192)
MSDA_BWD_CASES = [
    ("train extractor0/f1", 1, 1, MSDA_R - 0.5),
    ("train extractor1/f2", 2, 1, MSDA_R - 0.5),
    ("train extractor2/f4", 4, 1, MSDA_R - 0.5),
    ("train extractor3/f8", 8, 1, MSDA_R - 0.5),
    ("train f8, beyond r and past the borders", 8, 0, MSDA_R + 3),
    ("train f1, beyond r and past the borders", 1, 0, MSDA_R + 3),
]


# the sharded swin step's tap levels on a rank's H tile (a 1 x 2 grid, crop
# 384x768, batch 8: 48 of the 96 query rows, 192 columns, batch 16): (label,
# f, q0, query rows, v0, map rows, level rows); a tiled level carries
# radius + 1 halo rows each side (zero past the global edges), the 1/32
# level is whole (its Swin stage runs whole); and the 1/32 level read from
# query row 12 (12 rows a tile: a 384-row image over 8 ranks), not a
# multiple of f.  The rank 1 cases are one rank's 4 launches of a sharded
# swin step, timed as such
MSDA_TILE_CASES = [
    ("rank 1 tile extractor0/f1", 1, 48, 48, 42, 60, 96),
    ("rank 1 tile extractor1/f2", 2, 48, 48, 18, 36, 48),
    ("rank 1 tile extractor2/f4", 4, 48, 48, 6, 24, 24),
    ("rank 1 tile extractor3/f8", 8, 48, 48, 0, 12, 12),
    ("rank 0 tile f1, halo past the top edge", 1, 0, 48, -6, 60, 96),
    ("rank 0 tile f8, whole level", 8, 0, 48, 0, 12, 12),
    ("f8 whole level, query rows from 12", 8, 12, 12, 0, 12, 12),
]


def tap_grid(v32, dx, dy, aw, f, q0=0, v0=0):
    """The exact path's ``F.grid_sample`` inputs for tap samples on a level
    map whose rows are global rows v0 .. (queries from global row q0): the
    map with the heads folded into the batch, the grid and the weights."""
    import torch

    from nmrf_tpu_torch.ops import msda

    M, P, D = MSDA_HEADS, MSDA_POINTS, MSDA_HEAD_DIM
    B, Hq, Wq, _ = dx.shape
    n, Wl = v32.shape[1:3]
    dev = dx.device
    base_y = torch.as_tensor(msda.base_plus_one(Hq, f, q0) - 1 - v0, device=dev)
    base_x = torch.as_tensor(msda.base_plus_one(Wq, f) - 1, device=dev)
    gx = (base_x[None, None, :, None] + dx + 0.5) / Wl * 2 - 1
    gy = (base_y[None, :, None, None] + dy + 0.5) / n * 2 - 1
    grid = torch.stack([gx, gy], -1).reshape(B, Hq * Wq, M, P, 2)
    grid = grid.permute(0, 2, 1, 3, 4).reshape(B * M, Hq * Wq, P, 2)
    vh = v32.reshape(B, n, Wl, M, D).permute(0, 3, 4, 1, 2).reshape(B * M, D, n, Wl)
    w = aw.reshape(B, Hq * Wq, M, P).permute(0, 2, 1, 3).reshape(B * M, 1, Hq * Wq, P)
    return vh, grid, w


def msda_tile_phase(gen):
    """Phase 2: B5 and B5b at a rank's H tile (``MSDA_TILE_CASES``: query
    rows from q0, the level map's rows from v0 with the halo rows attached)
    against their plain versions in f32 and bf16, B5b on its vector path
    with the tap masks and two launches giving the same bits.  The rank 1
    cases are also timed (bf16) beside the plain versions, ``grid_sample``
    (and its backward) on the same samples and the bounds: one rank's 4
    launches of a sharded swin step.  Returns the entries of B5 and B5b,
    which count no launches of the kernels line (``count`` 0): their times
    go to its ``on_a_rank_tile`` field."""
    import torch
    import torch.nn.functional as F

    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.ops import msda

    dev = "cuda"
    M, P, D, r = MSDA_HEADS, MSDA_POINTS, MSDA_HEAD_DIM, MSDA_R
    B, Wq = 2 * TRAIN_BATCH, MSDA_TRAIN_Q[1]
    fwd, bwd = [], []
    for label, f, q0, hq, v0, n, Hg in MSDA_TILE_CASES:
        Wl = Wq // f
        rows = torch.arange(v0, v0 + n, device=dev)
        on_map = ((rows >= 0) & (rows < Hg)).float()[None, :, None, None]
        v32 = torch.randn(B, n, Wl, M * D, generator=gen, device=dev) * on_map
        dx, dy = ((torch.rand(B, hq, Wq, M * P, generator=gen, device=dev)
                   * 2 - 1) * (r - 0.5) for _ in range(2))
        aw = torch.softmax(torch.randn(B, hq, Wq, M, P, generator=gen,
                                       device=dev), -1).reshape(B, hq, Wq, M * P)
        g32 = torch.randn(B, hq, Wq, M * D, generator=gen, device=dev)
        tile = (q0, v0, Hg)
        shape = f"{label}: q0 {q0}, v0 {v0}, {n} of {Hg} level rows"
        ef = {"shape": shape, "count": 0}
        eb = {"shape": shape, "count": 0}
        for dtype_name, dt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
            v, g = v32.to(dt), g32.to(dt)
            with torch.inference_mode():
                got = msda.msda_taps(v, dx, dy, aw, M, r, *tile)
                torch.cuda.synchronize()
                want = msda.msda_taps_plain(v, dx, dy, aw, M, r, *tile)
            ef[f"max_abs_err_{dtype_name}"] = check_close(
                f"msda_taps {shape}", got, want, dtype_name)
            _native.reset_launch_counts()
            got = msda.msda_taps_bwd(v, dx, dy, aw, g, M, r, *tile)
            torch.cuda.synchronize()
            if _native.variant_counts()["msda_taps_bwd"] != {"vector_masks": 1}:
                fail(f"msda_taps_bwd {shape} {dtype_name}: launched "
                     f"{_native.variant_counts()['msda_taps_bwd']}, expected the "
                     "vector path with the tap masks")
            want = msda.msda_taps_bwd_plain(v, dx, dy, aw, g, M, r, *tile)
            eb[f"max_abs_err_{dtype_name}"] = max(
                check_close(f"msda_taps_bwd {shape} d{name}", a, b, dtype_name,
                            TOL_BWD)
                for name, a, b in zip(("value", "dx", "dy", "aw"), got, want))
            check_repeat(f"msda_taps_bwd {shape} {dtype_name}", got,
                         msda.msda_taps_bwd(v, dx, dy, aw, g, M, r, *tile))
            del got, want
        if label.startswith("rank 1 tile"):
            v, g = v32.to(torch.bfloat16), g32.to(torch.bfloat16)
            vh, grid, w = tap_grid(v32, dx, dy, aw, f, q0, v0)
            with torch.inference_mode():
                ef["ms"] = cuda_ms(lambda: msda.msda_taps(v, dx, dy, aw, M, r,
                                                          *tile), 50)
                ef["plain_ms"] = cuda_ms(lambda: msda.msda_taps_plain(
                    v, dx, dy, aw, M, r, *tile), 3, warmup=1)
                ef["library_ms"] = cuda_ms(lambda: (F.grid_sample(
                    vh, grid, align_corners=False) * w).sum(-1), 20)
            args = (v, dx, dy, aw, g, M, r, *tile)
            eb["ms"] = cuda_ms(lambda: msda.msda_taps_bwd(*args), 20)
            eb["plain_ms"] = cuda_ms(lambda: msda.msda_taps_bwd_plain(*args), 2,
                                     warmup=1)
            eb["library_ms"] = msda_bwd_library_ms(gen, v32, dx, dy, aw, f, q0, v0)
            ef["bytes_ms"], ef["ops_ms"] = msda_bound(B, hq, Wq, f, M, P, D, 2,
                                                      level_rows=n)
            eb["bytes_ms"], eb["ops_ms"] = msda_bwd_bound(
                B, hq, Wq, f, M, P, D, 2, kept_corners(dx, dy, r), level_rows=n)
            for e in (ef, eb):
                e.update(unit="tile", step_count=1)
            del vh, grid, w
        fwd.append(ef)
        bwd.append(eb)
        log(f"kernel msda_taps {shape}: " + json.dumps(ef))
        log(f"kernel msda_taps_bwd {shape}: " + json.dumps(eb))
    return fwd, bwd


def kept_corners(dx, dy, r):
    """Bilinear corners of these samples within r of their base cells: the
    corners whose terms B5b computes (map borders not subtracted)."""
    import torch

    def axis(d):
        d0 = torch.floor(d)
        return (d0.abs() <= r).int() + ((d0 + 1).abs() <= r).int()

    inside = (dx.abs() <= r + 1) & (dy.abs() <= r + 1)
    return int((axis(dx) * axis(dy) * inside).sum())


def check_bwd(name, got, want, dtype_name):
    """check_close of a window backward's (d(qkv), d(table)) at TOL_BWD;
    returns the larger error."""
    return max(check_close(f"{name} d{n}", a, b, dtype_name, TOL_BWD)
               for n, a, b in zip(("qkv", "table"), got, want))


def check_repeat(name, first, second):
    """Two launches on the same inputs must give the same bits."""
    import torch

    for a, b in zip(first, second):
        if not torch.equal(a, b):
            fail(f"{name}: two launches on the same inputs differ")


def check_close(name, got, want, dtype_name, tol=TOL):
    import torch

    atol, rtol = tol[dtype_name]
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
    """Phase 2 (forward kernels) and their timings of phase 6."""
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
        entry = {"shape": label, "count": per_frame}
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
        entry["bytes_ms"], entry["ops_ms"] = window_bound(1, Hp, Wp, N, ws, C,
                                                          heads)
        results["window_attention"].append(entry)
        log(f"kernel window_attention {label}: " + json.dumps(entry))
    # the training windows: checked in f32 at batch 1 and in bf16 at batch
    # TRAIN_BATCH, timed per training step (bf16, TRAIN_BATCH); count 0
    # keeps them out of the per-frame sums of the kernels line
    B = TRAIN_BATCH
    for label, Hp, Wp, N, ws, shift, cand, per_step in TRAIN_WINDOW_CASES:
        table = 0.5 * torch.randn((2 * ws - 1) ** 2, 3 * C, generator=gen,
                                  device=dev)
        entry = {"shape": label, "count": 0, "unit": "step",
                 "step_count": per_step}
        for dtype_name, dt, b in (("float32", torch.float32, 1),
                                  ("bfloat16", torch.bfloat16, B)):
            qkv = torch.randn(b, Hp, Wp, N, 3 * C, generator=gen, device=dev,
                              dtype=dt)
            got = A.window_attention(qkv, table, shift, (ws, ws), heads, cand)
            torch.cuda.synchronize()
            want = A.window_attention_plain(qkv, table, shift, (ws, ws), heads,
                                            cand)
            key = "max_abs_err_float32" if b == 1 else "max_abs_err_bfloat16_batch8"
            entry[key] = check_close(f"window_attention {label} batch {b}", got,
                                     want, dtype_name)
            del got, want
        entry["ms"] = cuda_ms(lambda: A.window_attention(
            qkv, table, shift, (ws, ws), heads, cand), 20)
        entry["plain_ms"] = cuda_ms(lambda: A.window_attention_plain(
            qkv, table, shift, (ws, ws), heads, cand), 3, warmup=1)
        T, hd = ws * ws * N, C // heads
        G = B * (Hp // ws) * (Wp // ws)
        qs, ks, vs = (torch.randn(G, heads, T, hd, generator=gen, device=dev,
                                  dtype=torch.bfloat16) for _ in range(3))
        bias = torch.randn(G, heads, T, T, generator=gen, device=dev,
                           dtype=torch.bfloat16)
        entry["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias), 20)
        entry["bytes_ms"], entry["ops_ms"] = window_bound(B, Hp, Wp, N, ws, C,
                                                          heads)
        del qs, ks, vs, bias
        results["window_attention"].append(entry)
        log(f"kernel window_attention {label}: " + json.dumps(entry))

    C, heads = 64, 2
    for label, Hp, Wp, N, H_sp, W_sp, per_frame in STRIPE_CASES:
        qkv32 = [torch.randn(1, Hp, Wp, N, C, generator=gen, device=dev)
                 for _ in range(3)]
        entry = {"shape": label, "count": per_frame}
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
        entry["bytes_ms"], entry["ops_ms"] = stripe_bound(1, Hp, Wp, N, H_sp,
                                                          W_sp, C, heads)
        results["stripe_attention"].append(entry)
        log(f"kernel stripe_attention {label}: " + json.dumps(entry))
    # checked, not timed here (count 0): the training stripes (f32 at batch
    # 1, bf16 at the training batch) and the horizontal stripes of a
    # sharded rank's tile (24 of the 48 rows at 1/8, 1 x 2 grid)
    cases = [c[:6] + (TRAIN_BATCH,) for c in TRAIN_STRIPE_CASES] \
        + [("sharded tile horizontal/T624", 24, 156, 4, 1, 156, 1)]
    for label, Hp, Wp, N, H_sp, W_sp, batch in cases:
        entry = {"shape": label, "count": 0}
        for dtype_name, dt, b in (("float32", torch.float32, 1),
                                  ("bfloat16", torch.bfloat16, batch)):
            q, k, v = (torch.randn(b, Hp, Wp, N, C, generator=gen, device=dev,
                                   dtype=dt) for _ in range(3))
            got = A.stripe_attention(q, k, v, H_sp, W_sp, heads)
            torch.cuda.synchronize()
            want = A.stripe_attention_plain(q, k, v, H_sp, W_sp, heads)
            entry[f"max_abs_err_{dtype_name}"] = check_close(
                f"stripe_attention {label} batch {b}", got, want, dtype_name)
        results["stripe_attention"].append(entry)
        log(f"kernel stripe_attention {label}: " + json.dumps(entry))
    return results


def sdpa_backward_ms(gen, G, heads, T, hd, mask):
    """Device ms of the backward of one bf16 SDPA with an additive mask,
    through torch.autograd.grad (the forward is run once, outside)."""
    import torch
    import torch.nn.functional as F

    qs, ks, vs = (torch.randn(G, heads, T, hd, generator=gen, device="cuda",
                              dtype=torch.bfloat16).requires_grad_()
                  for _ in range(3))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    g = torch.randn(out.shape, generator=gen, device="cuda", dtype=out.dtype)
    return cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), g,
                                               retain_graph=True), 10)


def split_ms(fn, ms, groups, iters=3):
    """Device time per call fn() by kernel, from torch.profiler's device
    intervals over iters calls after a warm-up: {group: ms} for each
    (group, name substrings) of ``groups``, and "rest": ms, the event-timed
    call, less the groups (K1b's ``_window_bwd_finish``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {g: 0.0 for g, _ in groups}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            for g, keys in groups:
                if any(k in evt.name for k in keys):
                    out[g] += evt.time_range.elapsed_us() / 1e3 / iters
    out["rest"] = ms - sum(out.values())
    return out


K1B_SPLIT = (("main", K1B_MAIN), ("dve", K1B_DVE))
# B5b's sample kernel (d dx, d dy, d aw and the tap masks), its cell-mask
# pass and its value kernel (d v: the gather, or the walk past r 5)
B5B_SPLIT = (("sample", ("msda_bwd_sample",)), ("cell_masks", ("msda_bwd_cell_mask",)),
             ("value", ("msda_bwd_gather", "msda_bwd_walk")))
B7_SPLIT = (("main", B7_MAIN), ("sum", B7_SUM))
# B6b's query-side and key-side kernels
B6B_SPLIT = (("dq", ("masked_bwd_dq",)), ("dkv", ("masked_bwd_dkv",)))


def bwd_kernel_phase(gen):
    """Phase 2 (backward kernels, checked in f32 and bf16 at batch 1 on the
    training and the KITTI shapes, and in bf16 at batch TRAIN_BATCH on the
    training shapes, as the training path launches them; two launches on
    the same inputs give the same bits) and their timings of phase 6 (the
    same batch-TRAIN_BATCH inputs; K1b also by kernel)."""
    import torch

    from nmrf_tpu_torch.ops import attention as A

    dev = "cuda"
    results = {"window_attention_bwd": [], "stripe_attention_bwd": []}
    C, heads = 128, 4
    cases = [c + (True,) for c in TRAIN_WINDOW_CASES] \
        + [c + (False,) for c in WINDOW_CASES]
    for label, Hp, Wp, N, ws, shift, cand, count, timed in cases:
        table = 0.5 * torch.randn((2 * ws - 1) ** 2, 3 * C, generator=gen,
                                  device=dev)
        qkv32 = torch.randn(1, Hp, Wp, N, 3 * C, generator=gen, device=dev)
        g32 = torch.randn(1, Hp, Wp, N, C, generator=gen, device=dev)
        entry = {"shape": label, "count": count if timed else 0}
        for dtype_name, dt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
            args = (g32.to(dt), qkv32.to(dt), table, shift, (ws, ws), heads,
                    cand)
            got = A.window_attention_bwd(*args)
            torch.cuda.synchronize()
            entry[f"max_abs_err_{dtype_name}"] = check_bwd(
                f"window_attention_bwd {label}", got,
                A.window_attention_bwd_plain(*args), dtype_name)
            check_repeat(f"window_attention_bwd {label} {dtype_name}", got,
                         A.window_attention_bwd(*args))
        if timed:
            B = TRAIN_BATCH
            qkv = torch.randn(B, Hp, Wp, N, 3 * C, generator=gen, device=dev,
                              dtype=torch.bfloat16)
            g = torch.randn(B, Hp, Wp, N, C, generator=gen, device=dev,
                            dtype=torch.bfloat16)
            args = (g, qkv, table, shift, (ws, ws), heads, cand)
            got = A.window_attention_bwd(*args)
            torch.cuda.synchronize()
            entry["max_abs_err_bfloat16_batch8"] = check_bwd(
                f"window_attention_bwd {label} batch {B}", got,
                A.window_attention_bwd_plain(*args), "bfloat16")
            check_repeat(f"window_attention_bwd {label} batch {B}", got,
                         A.window_attention_bwd(*args))
            del got
            entry["ms"] = cuda_ms(lambda: A.window_attention_bwd(*args), 10)
            entry["kernel_ms"] = split_ms(
                lambda: A.window_attention_bwd(*args), entry["ms"], K1B_SPLIT)
            entry["plain_ms"] = cuda_ms(
                lambda: A.window_attention_bwd_plain(*args), 3, warmup=1)
            T, G = ws * ws * N, B * (Hp // ws) * (Wp // ws)
            bias = torch.randn(G, heads, T, T, generator=gen, device=dev,
                               dtype=torch.bfloat16)
            entry["library_ms"] = sdpa_backward_ms(gen, G, heads, T, C // heads,
                                                   bias)
            entry["bytes_ms"], entry["ops_ms"] = window_bound(
                B, Hp, Wp, N, ws, C, heads, backward=True)
        results["window_attention_bwd"].append(entry)
        log(f"kernel window_attention_bwd {label}: " + json.dumps(entry))

    C, heads = 64, 2
    cases = [c + (True,) for c in TRAIN_STRIPE_CASES] \
        + [c + (False,) for c in STRIPE_CASES]
    for label, Hp, Wp, N, H_sp, W_sp, count, timed in cases:
        ts32 = [torch.randn(1, Hp, Wp, N, C, generator=gen, device=dev)
                for _ in range(4)]
        entry = {"shape": label, "count": count if timed else 0}
        for dtype_name, dt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
            args = tuple(t.to(dt) for t in ts32) + (H_sp, W_sp, heads)
            got = A.stripe_attention_bwd(*args)
            torch.cuda.synchronize()
            want = A.stripe_attention_bwd_plain(*args)
            entry[f"max_abs_err_{dtype_name}"] = max(
                check_close(f"stripe_attention_bwd {label} d{name}", a, b,
                            dtype_name, TOL_BWD)
                for name, a, b in zip("qkv", got, want))
            check_repeat(f"stripe_attention_bwd {label} {dtype_name}", got,
                         A.stripe_attention_bwd(*args))
        if timed:
            B = TRAIN_BATCH
            args = tuple(torch.randn(B, Hp, Wp, N, C, generator=gen, device=dev,
                                     dtype=torch.bfloat16) for _ in range(4))
            args += (H_sp, W_sp, heads)
            got = A.stripe_attention_bwd(*args)
            torch.cuda.synchronize()
            want = A.stripe_attention_bwd_plain(*args)
            entry["max_abs_err_bfloat16_batch8"] = max(
                check_close(f"stripe_attention_bwd {label} batch {B} d{name}",
                            a, b, "bfloat16", TOL_BWD)
                for name, a, b in zip("qkv", got, want))
            check_repeat(f"stripe_attention_bwd {label} batch {B}", got,
                         A.stripe_attention_bwd(*args))
            del got, want
            entry["ms"] = cuda_ms(lambda: A.stripe_attention_bwd(*args), 10)
            entry["plain_ms"] = cuda_ms(
                lambda: A.stripe_attention_bwd_plain(*args), 3, warmup=1)
            T, G = H_sp * W_sp * N, B * (Hp // H_sp) * (Wp // W_sp)
            mask = torch.as_tensor(A.stripe_mask(T, N), device=dev).to(
                torch.bfloat16)
            entry["library_ms"] = sdpa_backward_ms(gen, G, heads, T, C // heads,
                                                   mask)
            entry["bytes_ms"], entry["ops_ms"] = stripe_bound(
                B, Hp, Wp, N, H_sp, W_sp, C, heads, backward=True)
        results["stripe_attention_bwd"].append(entry)
        log(f"kernel stripe_attention_bwd {label}: " + json.dumps(entry))
    return results


def pos_bwd_kernel_phase(gen):
    """Phase 2 for B7, the fully fused window backward of the
    NMRF_FUSED_POS=1 training path: against its plain version in f32 and
    bf16 at batch 1 on the training and the KITTI shapes, and in bf16 at
    batch TRAIN_BATCH on the training shapes; against K1b on the same f32
    inputs (the same function, at TOL_BWD's f32 1e-4); two launches on the
    same inputs give the same bits (f32 at batch 1, bf16 at TRAIN_BATCH).
    Its timings of phase 6 as K1b's: the batch-TRAIN_BATCH inputs, its main
    and sum kernels apart, SDPA's backward with an additive mask as the
    yardstick, the bound of ``window_bound(..., backward=True)``."""
    import torch

    from nmrf_tpu_torch.ops import attention as A

    dev = "cuda"
    entries = []
    C, heads = 128, 4
    cases = [c + (True,) for c in TRAIN_WINDOW_CASES] \
        + [c + (False,) for c in WINDOW_CASES]
    for label, Hp, Wp, N, ws, shift, cand, count, timed in cases:
        name = f"window_attention_pos_bwd {label}"
        table = 0.5 * torch.randn((2 * ws - 1) ** 2, 3 * C, generator=gen,
                                  device=dev)
        qkv32 = torch.randn(1, Hp, Wp, N, 3 * C, generator=gen, device=dev)
        g32 = torch.randn(1, Hp, Wp, N, C, generator=gen, device=dev)
        entry = {"shape": label, "count": count if timed else 0}
        for dtype_name, dt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
            args = (g32.to(dt), qkv32.to(dt), table, shift, (ws, ws), heads,
                    cand)
            got = A.window_attention_pos_bwd(*args)
            torch.cuda.synchronize()
            entry[f"max_abs_err_{dtype_name}"] = check_bwd(
                name, got, A.window_attention_pos_bwd_plain(*args), dtype_name)
            if dtype_name == "float32":
                entry["max_abs_err_vs_k1b_float32"] = check_bwd(
                    f"{name} vs K1b", got, A.window_attention_bwd(*args),
                    "float32")
                check_repeat(name, got, A.window_attention_pos_bwd(*args))
        if timed:
            B = TRAIN_BATCH
            qkv = torch.randn(B, Hp, Wp, N, 3 * C, generator=gen, device=dev,
                              dtype=torch.bfloat16)
            g = torch.randn(B, Hp, Wp, N, C, generator=gen, device=dev,
                            dtype=torch.bfloat16)
            args = (g, qkv, table, shift, (ws, ws), heads, cand)
            got = A.window_attention_pos_bwd(*args)
            torch.cuda.synchronize()
            entry["max_abs_err_bfloat16_batch8"] = check_bwd(
                f"{name} batch {B}", got, A.window_attention_pos_bwd_plain(*args),
                "bfloat16")
            check_repeat(f"{name} batch {B}", got,
                         A.window_attention_pos_bwd(*args))
            del got
            entry["ms"] = cuda_ms(lambda: A.window_attention_pos_bwd(*args), 10)
            entry["kernel_ms"] = split_ms(
                lambda: A.window_attention_pos_bwd(*args), entry["ms"], B7_SPLIT)
            entry["plain_ms"] = cuda_ms(
                lambda: A.window_attention_pos_bwd_plain(*args), 3, warmup=1)
            T, G = ws * ws * N, B * (Hp // ws) * (Wp // ws)
            bias = torch.randn(G, heads, T, T, generator=gen, device=dev,
                               dtype=torch.bfloat16)
            entry["library_ms"] = sdpa_backward_ms(gen, G, heads, T, C // heads,
                                                   bias)
            entry["bytes_ms"], entry["ops_ms"] = window_bound(
                B, Hp, Wp, N, ws, C, heads, backward=True)
        entries.append(entry)
        log(f"kernel window_attention_pos_bwd {label}: " + json.dumps(entry))
    return {"window_attention_pos_bwd": entries}


def msda_phase(gen):
    """Phase 2 (B5 against its plain version in f32 and bf16 at the four
    extractor shapes of a swin KITTI request, batch 2, displacements within
    r; and two cases reaching beyond r and past the borders) and its
    timings of phase 6 (bf16, as the serving path runs it).  The library
    yardstick is the exact path's ``F.grid_sample`` with the heads folded
    into the batch, and the weighted sum over the points: the same function
    while every sample lies within r."""
    import torch
    import torch.nn.functional as F

    from nmrf_tpu_torch.ops import msda

    dev = "cuda"
    M, P, D, r = MSDA_HEADS, MSDA_POINTS, MSDA_HEAD_DIM, MSDA_R
    Hq, Wq = MSDA_Q
    B = 2
    entries = []
    for label, f, per_frame, spread in MSDA_CASES:
        Hl, Wl = Hq // f, Wq // f
        v32 = torch.randn(B, Hl, Wl, M * D, generator=gen, device=dev)
        dx, dy = ((torch.rand(B, Hq, Wq, M * P, generator=gen, device=dev)
                   * 2 - 1) * spread for _ in range(2))
        aw = torch.softmax(torch.randn(B, Hq, Wq, M, P, generator=gen,
                                       device=dev), -1).reshape(B, Hq, Wq, M * P)
        entry = {"shape": label, "count": per_frame,
                 "beyond_r_share": ((dx.abs() > r) | (dy.abs() > r)).float()
                 .mean().item()}
        for dtype_name, dt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
            v = v32.to(dt)
            got = msda.msda_taps(v, dx, dy, aw, M, r)
            torch.cuda.synchronize()
            want = msda.msda_taps_plain(v, dx, dy, aw, M, r)
            entry[f"max_abs_err_{dtype_name}"] = check_close(
                f"msda_taps {label}", got, want, dtype_name)
        if per_frame:
            v = v32.to(torch.bfloat16)
            entry["ms"] = cuda_ms(lambda: msda.msda_taps(v, dx, dy, aw, M, r), 50)
            entry["plain_ms"] = cuda_ms(
                lambda: msda.msda_taps_plain(v, dx, dy, aw, M, r), 3, warmup=1)
            # exact path at the same samples: level pixel base + d
            vh, grid, w = tap_grid(v32, dx, dy, aw, f)
            entry["library_ms"] = cuda_ms(lambda: (F.grid_sample(
                vh, grid, align_corners=False) * w).sum(-1), 20)
            entry["bytes_ms"], entry["ops_ms"] = msda_bound(
                B, Hq, Wq, f, M, P, D, 2)
        entries.append(entry)
        log(f"kernel msda_taps {label}: " + json.dumps(entry))
    return {"msda_taps": entries}


def msda_bwd_inputs(gen, B, f, spread):
    """B5b's inputs at the swin training step's query grid and level f:
    the level map and g (f32, N(0, 1)), displacements uniform within
    +-spread level pixels, softmax weights."""
    import torch

    dev = "cuda"
    M, P, D = MSDA_HEADS, MSDA_POINTS, MSDA_HEAD_DIM
    Hq, Wq = MSDA_TRAIN_Q
    Hl, Wl = Hq // f, Wq // f
    v32 = torch.randn(B, Hl, Wl, M * D, generator=gen, device=dev)
    dx, dy = ((torch.rand(B, Hq, Wq, M * P, generator=gen, device=dev)
               * 2 - 1) * spread for _ in range(2))
    aw = torch.softmax(torch.randn(B, Hq, Wq, M, P, generator=gen,
                                   device=dev), -1).reshape(B, Hq, Wq, M * P)
    g32 = torch.randn(B, Hq, Wq, M * D, generator=gen, device=dev)
    return v32, dx, dy, aw, g32


def msda_bwd_library_ms(gen, v32, dx, dy, aw, f, q0=0, v0=0):
    """The backward of the exact path's ``F.grid_sample`` on B5b's samples
    (f32, heads folded into the batch, with the weighted sum over the
    points; on an H tile at the row offsets of ``tap_grid``): one library
    call of the same function while every sample lies within r."""
    import torch
    import torch.nn.functional as F

    vh, grid, w = (t.requires_grad_()
                   for t in tap_grid(v32, dx, dy, aw, f, q0, v0))
    out = (F.grid_sample(vh, grid, align_corners=False) * w).sum(-1)
    cot = torch.randn(out.shape, generator=gen, device=dx.device)
    return cuda_ms(lambda: torch.autograd.grad(out, (vh, grid, w), cot,
                                               retain_graph=True), 10)


def msda_bwd_phase(gen):
    """Phase 2 for B5b: against its plain version in f32 and bf16 at the
    four extractor shapes of a swin training step (batch 16, query grid
    96 x 192, displacements within r) and two cases reaching beyond r and
    past the borders, each launch on the vector path with the tap masks;
    two launches give the same bits.  Its timings of phase 6 (bf16, as the
    training path runs it), also by kernel (``B5B_SPLIT``: the sample
    kernel, the cell masks and the value kernel apart), beside the backward
    of the exact path's ``F.grid_sample`` on the same samples."""
    import torch

    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.ops import msda

    M, P, D, r = MSDA_HEADS, MSDA_POINTS, MSDA_HEAD_DIM, MSDA_R
    Hq, Wq = MSDA_TRAIN_Q
    B = 2 * TRAIN_BATCH
    entries = []
    for label, f, per_step, spread in MSDA_BWD_CASES:
        v32, dx, dy, aw, g32 = msda_bwd_inputs(gen, B, f, spread)
        entry = {"shape": label, "count": per_step,
                 "inputs": f"uniform within +-{spread} level pixels",
                 "beyond_r_share": ((dx.abs() > r) | (dy.abs() > r)).float()
                 .mean().item()}
        for dtype_name, dt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
            args = (v32.to(dt), dx, dy, aw, g32.to(dt), M, r)
            _native.reset_launch_counts()
            got = msda.msda_taps_bwd(*args)
            torch.cuda.synchronize()
            if _native.variant_counts()["msda_taps_bwd"] != {"vector_masks": 1}:
                fail(f"msda_taps_bwd {label} {dtype_name}: launched "
                     f"{_native.variant_counts()['msda_taps_bwd']}, expected the "
                     "vector path with the tap masks")
            want = msda.msda_taps_bwd_plain(*args)
            entry[f"max_abs_err_{dtype_name}"] = max(
                check_close(f"msda_taps_bwd {label} d{name}", a, b, dtype_name,
                            TOL_BWD)
                for name, a, b in zip(("value", "dx", "dy", "aw"), got, want))
            check_repeat(f"msda_taps_bwd {label} {dtype_name}", got,
                         msda.msda_taps_bwd(*args))
            del got, want
        if per_step:
            args = (v32.to(torch.bfloat16), dx, dy, aw, g32.to(torch.bfloat16),
                    M, r)
            entry["ms"] = cuda_ms(lambda: msda.msda_taps_bwd(*args), 20)
            entry["split_ms"] = split_ms(lambda: msda.msda_taps_bwd(*args),
                                         entry["ms"], B5B_SPLIT)
            entry["plain_ms"] = cuda_ms(lambda: msda.msda_taps_bwd_plain(*args),
                                        2, warmup=1)
            entry["library_ms"] = msda_bwd_library_ms(gen, v32, dx, dy, aw, f)
            entry["bytes_ms"], entry["ops_ms"] = msda_bwd_bound(
                B, Hq, Wq, f, M, P, D, 2, kept_corners(dx, dy, r))
        entries.append(entry)
        log(f"kernel msda_taps_bwd {label}: " + json.dumps(entry))
    return {"msda_taps_bwd": entries}


def captured_msda_bwd_inputs(step, batch):
    """The inputs of the B5b launches of one swin training step ``step(batch)``
    (clones, in launch order: the extractors at f 1, 2, 4, 8)."""
    import torch

    from nmrf_tpu_torch.ops import msda

    seen, launch = [], msda.msda_taps_bwd

    def record(*args):
        seen.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return launch(*args)

    msda.msda_taps_bwd = record
    try:
        step(batch)
        torch.cuda.synchronize()
    finally:
        msda.msda_taps_bwd = launch
    if len(seen) != 4:
        fail(f"a swin step launched B5b {len(seen)} times, expected 4")
    return seen


def msda_bwd_main_path_phase(step, batch):
    """B5b on the samples of the main path: the 4 launches of a swin
    training step (bf16, the neck's samples at their random initial
    weights), held against its plain version (TOL_BWD) and itself on the
    step's own inputs, and again with the level map and g drawn N(0, 1)
    (a step's g is small, so only these values hold the sparse masks'
    path to the tolerance), timed on the latter (also by kernel,
    ``B5B_SPLIT``) beside the plain version, ``grid_sample``'s backward on
    the same samples and the bound of these samples' kept corners.  These
    entries count no launches of the kernels line (``count`` 0): its B5b
    times stay those of phase 2's uniform inputs, and these go to its
    ``on_training_step_inputs`` field (``step_count``, ``unit``
    "step_inputs")."""
    import torch

    from nmrf_tpu_torch.ops import msda

    gen = torch.Generator(device="cuda").manual_seed(9)
    entries = []
    for captured in captured_msda_bwd_inputs(step, batch):
        v, dx, dy, aw, g, M, r = captured
        B, Hq, Wq, _ = dx.shape
        f = Hq // v.shape[1]
        label = f"train step extractor/f{f}"
        entry = {"shape": label, "count": 0, "unit": "step_inputs",
                 "step_count": 1,
                 "inputs": "a swin training step's dx, dy and aw; v and g as "
                           "the step's and N(0, 1)",
                 "beyond_r_share": ((dx.abs() > r) | (dy.abs() > r)).float()
                 .mean().item()}
        drawn = (torch.randn(v.shape, generator=gen, device=v.device).to(v.dtype),
                 dx, dy, aw,
                 torch.randn(g.shape, generator=gen, device=g.device).to(g.dtype),
                 M, r)
        for key, args in (("max_abs_err_step_values", captured),
                          ("max_abs_err_bfloat16", drawn)):
            got = msda.msda_taps_bwd(*args)
            want = msda.msda_taps_bwd_plain(*args)
            entry[key] = max(
                check_close(f"msda_taps_bwd {label} ({key}) d{name}", a, b,
                            "bfloat16", TOL_BWD)
                for name, a, b in zip(("value", "dx", "dy", "aw"), got, want))
            check_repeat(f"msda_taps_bwd {label} ({key})", got,
                         msda.msda_taps_bwd(*args))
            del got, want
        args = drawn
        entry["ms"] = cuda_ms(lambda: msda.msda_taps_bwd(*args), 20)
        entry["split_ms"] = split_ms(lambda: msda.msda_taps_bwd(*args),
                                     entry["ms"], B5B_SPLIT)
        entry["plain_ms"] = cuda_ms(lambda: msda.msda_taps_bwd_plain(*args), 2,
                                    warmup=1)
        entry["library_ms"] = msda_bwd_library_ms(gen, args[0].float(), dx, dy,
                                                  aw, f)
        entry["bytes_ms"], entry["ops_ms"] = msda_bwd_bound(
            B, Hq, Wq, f, M, MSDA_POINTS, MSDA_HEAD_DIM, 2, kept_corners(dx, dy, r))
        entries.append(entry)
        log(f"kernel msda_taps_bwd {label}: " + json.dumps(entry))
    return entries


# H-sharded path (1 x 2 grid): the CSWin vertical stripe of a tile attends
# its 24 of 48 rows at 1/8 to the gathered stripe: Rq = 24 x 4 = 96 query
# rows, Rk = 48 x 4 = 192 key rows, 2 heads of 32, G = batch x 1/8 width
# (KITTI 384x1248, batch 1: 156; training 384x768, batch 8: 768).
# (label, G, B6 launches per sharded frame, B6b launches per sharded step):
# each kernel's unit is its main path's (serving for B6, training for B6b)
MASKED_RQ, MASKED_RK, MASKED_HEADS, MASKED_HD, MASKED_N = 96, 192, 2, 32, 4
MASKED_CASES = [
    ("serve G156", 156, 5, 0),
    ("train G768", 768, 0, 5),
]
# a ragged shape (a 48-row query block over 40 rows; 64 + 8 keys), one
# mask per group: (G, Rq, Rk)
MASKED_RAGGED = (24, 40, 72)
# K1/K1b on a tile of the sharded training shapes (row0 > 0, hp_total > Hp):
# (label, Hp, Wp, N, ws, shift, candidate_mask, row0, hp_total)
ROW0_CASES = [
    ("tile1 inference/shift3", 24, 96, 4, 6, 3, True, 24, 48),
    ("tile0 inference/shift3", 24, 96, 4, 6, 3, True, 0, 48),
    ("tile1 refinement/shift2", 48, 192, 1, 4, 2, False, 48, 96),
]


def tile_stripe_mask(tile):
    """[1, Rq, Rk] rows of the global anti-same-pixel stripe mask for a tile,
    on the card: the sharded CSWin layer's own cached mask."""
    import torch

    from nmrf_tpu_torch.models import nmp

    return nmp.tile_stripe_mask(MASKED_RK, MASKED_N, tile, MASKED_RQ,
                                torch.device("cuda", 0))


def per_group_mask(gen, G, Rq, Rk):
    """[G, Rq, Rk] random additive mask: a fifth of the entries -1e9, the
    rest standard normal, and query row 1 masked everywhere (the plain
    version's uniform softmax)."""
    import torch

    mask = torch.where(
        torch.rand(G, Rq, Rk, generator=gen, device="cuda") < 0.2, -1e9,
        torch.randn(G, Rq, Rk, generator=gen, device="cuda"))
    mask[:, 1] = -1e9
    return mask


def masked_checks(gen, label, G, Rq, Rk, masks):
    """B6 and B6b against their plain versions in f32 and bf16 for each
    mask, and two bf16 B6b launches for the same bits; ({"max_abs_err_<dtype>":
    ...} of B6, the same of B6b)."""
    import torch

    from nmrf_tpu_torch.ops import attention as A

    h, hd = MASKED_HEADS, MASKED_HD
    scale = hd ** -0.5
    q32, g32 = (torch.randn(h, G, Rq, hd, generator=gen, device="cuda")
                for _ in range(2))
    k32, v32 = (torch.randn(h, G, Rk, hd, generator=gen, device="cuda")
                for _ in range(2))
    ef, eb = {}, {}
    for dtype_name, dt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
        q, k, v, g = (t.to(dt) for t in (q32, k32, v32, g32))
        errs_f, errs_b = [], []
        for mname, mask in masks.items():
            with torch.inference_mode():
                got = A.masked_attention(q, k, v, mask, scale)
                torch.cuda.synchronize()
                want = A.masked_attention_plain(q, k, v, mask, scale)
            errs_f.append(check_close(f"masked_attention {label} {mname}",
                                      got, want, dtype_name))
            got = A.masked_attention_bwd(g, q, k, v, mask, scale)
            torch.cuda.synchronize()
            want = A.masked_attention_bwd_plain(g, q, k, v, mask, scale)
            errs_b.extend(check_close(
                f"masked_attention_bwd {label} {mname} d{n}", a, b,
                dtype_name, TOL_BWD) for n, a, b in zip("qkv", got, want))
            if dtype_name == "bfloat16":
                check_repeat(f"masked_attention_bwd {label} {mname}", got,
                             A.masked_attention_bwd(g, q, k, v, mask, scale))
        ef[f"max_abs_err_{dtype_name}"] = max(errs_f)
        eb[f"max_abs_err_{dtype_name}"] = max(errs_b)
    return ef, eb


def masked_phase(gen):
    """Phase 2 (B6 and B6b against their plain versions, f32 and bf16, at
    the sharded path's shapes (serving G 156, training G 768), with the
    tile-0 and tile-1 stripe masks (Gm = 1) and a random mask per group (Gm
    = G, one row masked everywhere), then on a ragged shape; two bf16 B6b
    launches give the same bits) and their timings of phase 6 (bf16, tile-1
    mask as the path runs it; SDPA with the same additive mask, forward and
    backward)."""
    import torch
    import torch.nn.functional as F

    from nmrf_tpu_torch.ops import attention as A

    dev = "cuda"
    h, Rq, Rk, hd = MASKED_HEADS, MASKED_RQ, MASKED_RK, MASKED_HD
    scale = hd ** -0.5
    fwd, bwd = [], []
    for label, G, fwd_count, bwd_count in MASKED_CASES:
        masks = {f"tile{t}": tile_stripe_mask(t) for t in (0, 1)}
        masks["per-group"] = per_group_mask(gen, G, Rq, Rk)
        ef, eb = masked_checks(gen, label, G, Rq, Rk, masks)
        ef.update(shape=label, count=fwd_count)
        eb.update(shape=label, count=bwd_count)
        q, g = (torch.randn(h, G, Rq, hd, generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(h, G, Rk, hd, generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        mask = masks["tile1"]
        bmask = mask.to(torch.bfloat16)
        with torch.inference_mode():
            ef["ms"] = cuda_ms(lambda: A.masked_attention(q, k, v, mask, scale), 50)
            ef["plain_ms"] = cuda_ms(
                lambda: A.masked_attention_plain(q, k, v, mask, scale), 10)
            ef["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bmask), 50)
        ef["bytes_ms"], ef["ops_ms"] = masked_bound(G, Rq, Rk, h, hd, 1)
        eb["ms"] = cuda_ms(lambda: A.masked_attention_bwd(g, q, k, v, mask, scale), 20)
        eb["plain_ms"] = cuda_ms(
            lambda: A.masked_attention_bwd_plain(g, q, k, v, mask, scale), 5)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bmask)
        eb["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), g, retain_graph=True), 20)
        eb["bytes_ms"], eb["ops_ms"] = masked_bound(G, Rq, Rk, h, hd, 1,
                                                    backward=True)
        del out, qs, ks, vs
        fwd.append(ef)
        bwd.append(eb)
        log(f"kernel masked_attention {label}: " + json.dumps(ef))
        log(f"kernel masked_attention_bwd {label}: " + json.dumps(eb))
    G, Rq, Rk = MASKED_RAGGED
    label = f"ragged G{G} Rq{Rq} Rk{Rk}"
    ef, eb = masked_checks(gen, label, G, Rq, Rk,
                           {"per-group": per_group_mask(gen, G, Rq, Rk)})
    for entries, entry in ((fwd, ef), (bwd, eb)):
        entry.update(shape=label, count=0)
        entries.append(entry)
        log(f"kernel masked {label}: " + json.dumps(entry))
    return {"masked_attention": fwd, "masked_attention_bwd": bwd}


def row0_phase(gen):
    """Phase 2: K1, K1b and B7 on a tile of a taller image (row0 > 0 or
    hp_total > Hp, the shifted-region mask in global rows) against their
    plain versions, f32 and bf16, at the sharded training shapes; entries
    with no timed launches, folded into K1's, K1b's and B7's rows."""
    import torch

    from nmrf_tpu_torch.ops import attention as A

    dev = "cuda"
    C, heads = 128, 4
    fwd, bwd, pos = [], [], []
    for label, Hp, Wp, N, ws, shift, cand, row0, hp_total in ROW0_CASES:
        table = 0.5 * torch.randn((2 * ws - 1) ** 2, 3 * C, generator=gen,
                                  device=dev)
        qkv32 = torch.randn(2, Hp, Wp, N, 3 * C, generator=gen, device=dev)
        g32 = torch.randn(2, Hp, Wp, N, C, generator=gen, device=dev)
        ef, eb, ep = ({"shape": f"{label} row0 {row0} of {hp_total}",
                       "count": 0} for _ in range(3))
        for dtype_name, dt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
            args = (qkv32.to(dt), table, shift, (ws, ws), heads, cand, row0,
                    hp_total)
            with torch.inference_mode():
                got = A.window_attention(*args)
                torch.cuda.synchronize()
                want = A.window_attention_plain(*args)
            ef[f"max_abs_err_{dtype_name}"] = check_close(
                f"window_attention {label}", got, want, dtype_name)
            for entry, kernel, plain in (
                    (eb, A.window_attention_bwd, A.window_attention_bwd_plain),
                    (ep, A.window_attention_pos_bwd,
                     A.window_attention_pos_bwd_plain)):
                got = kernel(g32.to(dt), *args)
                torch.cuda.synchronize()
                entry[f"max_abs_err_{dtype_name}"] = check_bwd(
                    f"{kernel.__name__} {label}", got,
                    plain(g32.to(dt), *args), dtype_name)
        fwd.append(ef)
        bwd.append(eb)
        pos.append(ep)
        log(f"kernel window_attention {ef['shape']}: " + json.dumps(ef))
        log(f"kernel window_attention_bwd {eb['shape']}: " + json.dumps(eb))
        log(f"kernel window_attention_pos_bwd {ep['shape']}: " + json.dumps(ep))
    return fwd, bwd, pos


# --------------------------------------------------------------------------- #
# main paths
# --------------------------------------------------------------------------- #

def main_path_cfg(dtype, gelu_approx, use_kernels, swin=False, grid=None):
    """The default config (resnet, 5 + 5 + 5 NMP layers), or with ``swin``
    the swin variant's (Swin-T, deformable neck, tap radius 5, DIVIS_BY 32);
    ``grid`` (data, spatial) sets ``TPU.MESH_DATA``/``MESH_SPATIAL``."""
    from pathlib import Path

    from nmrf_tpu_torch.config import get_cfg

    cfg = get_cfg()
    if swin:
        cfg.merge_from_file(str(Path(__file__).resolve().parent / "configs"
                                / "sceneflow_swint.yaml"))
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TPU.GELU_APPROX = gelu_approx
    cfg.TPU.USE_PALLAS = use_kernels
    if grid is not None:
        cfg.TPU.MESH_DATA, cfg.TPU.MESH_SPATIAL = grid
    cfg.freeze()
    return cfg


def tap_oob_fractions(model, pair):
    """Phase 3a (swin): one request with a hook on every extractor's
    deformable attention (``tools/check_tap_coverage.py:tap_coverage``);
    returns, per extractor, whether it took the tap path and the share of
    its samples beyond the tap radius (``tap_out_of_range_fraction``: 0.0
    means the tap path was exact)."""
    import torch

    from nmrf_tpu_torch.data import InputPadder
    from nmrf_tpu_torch.tools.check_tap_coverage import tap_coverage

    padder = InputPadder(pair[0].shape, mode="proposal", divis_by=model.divis_by)
    img1, img2 = (torch.from_numpy(p[None]).cuda() for p in padder.pad(*pair))
    return [{"taps": r["taps"], "level": r["levels"][0],
             "oob_fraction": max(r["oob_fractions"])}
            for r in tap_coverage(model, img1, img2)]


def serve_phase(swin=False):
    """Phase 3a: requests through predict; returns timings and counts."""
    import torch

    from nmrf_tpu_torch import build_model, predict
    from nmrf_tpu_torch.ops import _native

    model = build_model(main_path_cfg("bfloat16", True, True, swin))
    rng = np.random.RandomState(0)
    pairs = [((rng.rand(H_KITTI, W_KITTI, 3) * 255).astype(np.float32),
              (rng.rand(H_KITTI, W_KITTI, 3) * 255).astype(np.float32))
             for _ in range(REQUESTS + 1)]
    t0 = time.perf_counter()
    predict(model, *pairs[0])  # warm-up: cuDNN plans, first kernel launches
    warmup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    _native.reset_launch_counts()
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
    counts = _native.launch_counts()
    frame_ms = start.elapsed_time(end) / REQUESTS

    for d in disps:
        if d.shape != (H_KITTI, W_KITTI):
            fail(f"disparity shape {d.shape}")
        if not np.isfinite(d).all() or (d < 0).any():
            fail("disparity not finite and non-negative")
    _expect_launches(counts, f"{REQUESTS} requests",
                     window_attention=10 * REQUESTS,
                     stripe_attention=10 * REQUESTS,
                     msda_taps=(4 if swin else 0) * REQUESTS)
    return model, pairs[1], {
        "model": "swin" if swin else "resnet",
        "requests": REQUESTS, "frame_ms": frame_ms, "host_request_ms": host_ms,
        "warmup_s": warmup_s, "launches": counts,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "disp_mean": float(np.mean([d.mean() for d in disps]))}


def train_setup(swin=False):
    """(cfg, step, batch) of the training path: the full-width default
    model, or with ``swin`` the swin variant's with the tap-path monitor
    on, bf16, its optimizer and step, and a fixed synthetic batch at the
    config's crop (384x768) and batch (8)."""
    import torch

    from nmrf_tpu_torch import (build_criterion, build_model, build_optimizer,
                                make_train_step)
    from nmrf_tpu_torch.data import synthetic_batch

    cfg = main_path_cfg("bfloat16", False, True, swin)
    model = build_model(cfg)
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg.SOLVER.ACCUM_STEPS,
                           grad_clip=cfg.SOLVER.GRAD_CLIP, monitor_oob=swin)
    B = cfg.SOLVER.IMS_PER_BATCH
    H, W = cfg.DATASETS.CROP_SIZE
    # disparities on whole 1/8-resolution cost-volume bins, as the JAX
    # package's convergence gate draws them: with unaligned ones the loss
    # sits on a plateau at random init (the integer proposal seeds
    # reshuffle and move the coarse losses while epe_train falls)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        B, H, W, max_disp=cfg.SOLVER.MAX_DISP, seed=0, disp_quantum=8).items()}
    return cfg, step, batch


def train_phase(fused=False, swin=False):
    """Phase 5: training steps of the full-width default model, bf16, crop
    384x768, batch 8, on a fixed synthetic batch; ``fused``: run inside
    ``fused_pos()``, where B7 takes K1b's launches; ``swin``: the swin
    variant (drop-path 0.4) over SWIN_TRAIN_STEPS timed steps, 4 B5 and 4
    B5b launches a step more, and ``msda_tap_oob`` reported by every step,
    0 at init."""
    import torch

    from nmrf_tpu_torch.ops import _native

    cfg, step, batch = train_setup(swin)
    B = cfg.SOLVER.IMS_PER_BATCH
    H, W = cfg.DATASETS.CROP_SIZE
    steps = SWIN_TRAIN_STEPS if swin else TRAIN_STEPS
    t0 = time.perf_counter()
    history = [step(batch)]  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    _native.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    history += [step(batch) for _ in range(steps)]
    end.record()
    torch.cuda.synchronize()
    counts = _native.launch_counts()
    step_ms = start.elapsed_time(end) / steps

    rows = [{k: float(v) for k, v in h.items()} for h in history]
    tag = " (NMRF_FUSED_POS=1)" if fused else " (swin)" if swin else ""
    for i, row in enumerate(rows):
        log(f"train step {i}{tag}: total {row['total']:.4f} epe_train "
            f"{row['epe_train']:.4f} loss_prop {row['loss_prop']:.4f} "
            f"init {row['init']:.4f} loss_coarse_disp_4 "
            f"{row['loss_coarse_disp_4']:.4f} grad_norm {row['grad_norm']:.4f}")
        if not all(np.isfinite(v) for v in row.values()):
            fail(f"train step {i}{tag}: non-finite loss or gradient norm {row}")
    fwd = (2 if cfg.TPU.REMAT else 1) * 10 * steps
    window_bwd = "window_attention_pos_bwd" if fused else "window_attention_bwd"
    taps = {"msda_taps": 4 * steps, "msda_taps_bwd": 4 * steps} if swin else {}
    _expect_launches(counts, f"{steps} steps{tag}", window_attention=fwd,
                     stripe_attention=fwd, stripe_attention_bwd=10 * steps,
                     **{window_bwd: 10 * steps}, **taps)
    oob = {}
    if swin:
        variants = _native.variant_counts()
        if variants["msda_taps_bwd"] != {"vector_masks": 4 * steps} or \
                variants["msda_taps"] != {"vector": 4 * steps}:
            fail(f"swin steps: B5/B5b variants {variants}, expected only the "
                 "vector kernels (B5b with its tap masks)")
        oob["variants"] = variants
        oob["msda_tap_oob"] = [r.get("msda_tap_oob") for r in rows]
        if None in oob["msda_tap_oob"] or oob["msda_tap_oob"][0] != 0.0:
            fail(f"swin steps: msda_tap_oob {oob['msda_tap_oob']}, expected "
                 "one a step and 0.0 at init")
        oob["msda_tap_oob_read"] = step.read_oob()
    timed = [r["total"] for r in rows[1:]]
    first, last = float(np.mean(timed[:3])), float(np.mean(timed[-3:]))
    if not last < first:
        fail(f"loss did not fall{tag}: mean total {first:.4f} over the first 3 "
             f"timed steps, {last:.4f} over the last 3")
    return step, batch, {
        "fused_pos": fused, "model": "swin" if swin else "resnet", **oob,
        "batch": B, "crop": [H, W], "steps": steps, "step_ms": step_ms,
        "frames_per_s": B / step_ms * 1e3, "warmup_s": warmup_s,
        "remat": bool(cfg.TPU.REMAT), "launches": counts,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "total_first3": first, "total_last3": last,
        "disp_quantum": 8,
        "losses": [{k: r[k] for k in ("total", "epe_train", "grad_norm")}
                   for r in rows]}


COLLECTIVE_KEYS = ("gloo", "nccl", "c10d", "all_gather", "allgather",
                   "all_reduce", "allreduce")


def profile_phase(name, fn):
    """Phase 6b: one call of fn under torch.profiler, its chrome trace read
    by ``profile_model.summarize_trace`` (the profilers' one summary):
    device time by kernel group, the busy time (union of the device
    intervals) and idle share (1 - busy over the trace's window); beside
    them the call's wall time and the host time inside torch.distributed
    collectives (union of their host intervals; 0 without a process
    group)."""
    import shutil
    import tempfile

    import torch

    from nmrf_tpu_torch.tools import profile_model

    wall = []

    def call():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    work = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        path = profile_model.profile(call, os.path.join(work, "trace.json"),
                                     "cuda")
        _, busy, idle, groups = profile_model.summarize_trace(path, top=0)
        coll = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in profile_model._events(path)
                if e.get("cat") not in profile_model.DEVICE_CATS
                and not e.get("cat", "").startswith("gpu_")  # device ranges
                and any(k in e["name"].lower() for k in COLLECTIVE_KEYS)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for group, (ms, count) in groups.items():
        log(f"profile {name}: {ms:9.3f} ms  x{count:<5d} {group}")
    if not groups:
        fail(f"profiler recorded no device activity ({name})")
    return {"wall_ms": wall[0], "device_busy_ms": busy,
            "device_idle_share": idle,
            "collective_host_ms": _union_ms(coll),
            "groups": [{"group": g, "ms": ms, "launches": c}
                       for g, (ms, c) in groups.items()]}


def parity_phase(swin=False):
    """Phase 3b: float32 full-size forward, kernels vs plain versions."""
    import torch

    from nmrf_tpu_torch import build_model
    from nmrf_tpu_torch.ops import _native

    kern = build_model(main_path_cfg("float32", False, True, swin))
    plain = build_model(main_path_cfg("float32", False, False, swin))
    plain.load_state_dict(kern.state_dict())
    rng = np.random.RandomState(1)
    # InputPadder "proposal" size of 375x1242 at DIVIS_BY 8 (resnet), 32 (swin)
    Hp, Wp = (384, 1248) if swin else (376, 1248)
    img1, img2 = (torch.from_numpy((rng.rand(1, Hp, Wp, 3) * 255).astype(
        np.float32)).cuda() for _ in range(2))
    scores = {}

    def grab(name):
        def hook(_module, _inputs, output):
            scores[name] = output
        return hook

    outs, launches = {}, {}
    for name, model in (("kernels", kern), ("plain", plain)):
        handle = model.infer_score_head.register_forward_hook(grab(name))
        _native.reset_launch_counts()
        with torch.inference_mode():
            outs[name] = model(img1, img2)
        torch.cuda.synchronize()
        launches[name] = _native.launch_counts()
        handle.remove()
    got, ref = outs["kernels"], outs["plain"]
    if any(launches["plain"].values()) or not all(
            launches["kernels"][k] for k in (
                "window_attention", "stripe_attention")
            + (("msda_taps",) if swin else ())):
        fail(f"parity forward launches: {launches}")
    return {"model": "swin" if swin else "resnet",
            **check_forward(got, ref, scores["plain"][-1])}


def check_forward(got, ref, logits):
    """Hold one f32 forward's outputs against a reference forward's on the
    same weights and inputs; logits: the reference's last proposal scores
    [B, h8, w8, N, 64] (for the tie-aware disparity check)."""
    import torch
    import torch.nn.functional as F

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


def stage_grad_phase():
    """Phase 4: float32 gradients of the three stages (train mode, full
    width, training shape 48x96 / 96x192, batch 1) through the kernels
    against the same stages on the plain versions, identical weights and
    inputs; then the Inference and Refinement stages again inside
    ``fused_pos()`` (K1 and B7, no K1b; the plain stages ignore the flag).
    No argmax lies inside a stage, so every parameter gradient and every
    input gradient is held at atol = rtol = 1e-4.  The cotangent is
    N(0, 1) / sqrt(output rows), so every gradient is of order one."""
    import torch

    from nmrf_tpu_torch import build_model
    from nmrf_tpu_torch.ops import _native

    kern = build_model(main_path_cfg("float32", False, True))
    plain = build_model(main_path_cfg("float32", False, False))
    plain.load_state_dict(kern.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    h8, w8, h4, w4 = 48, 96, 96, 192
    M = h8 * w8
    cases = {
        "propagation": (lambda m: m.dpn.propagation, (
            rand(M, 4, 40),
            torch.randint(0, 40, (M, 4), generator=gen, device="cuda"),
            rand(1, h8, w8, 64))),
        "inference": (lambda m: m.inference, (
            6 + 4 * rand(1, h8, w8, 4).abs(), rand(1, h8, w8, 64),
            rand(1, h8, w8, 64), rand(1, h8, w8, 256), rand(1, h8, w8, 256))),
        "refinement": (lambda m: m.refinement, (
            12 + 8 * rand(1, h4, w4).abs(), rand(1, h4, w4, 64),
            rand(1, h4, w4, 64), rand(1, h4, w4, 256), rand(1, h4, w4, 256))),
    }
    report = {}
    runs = [(name, False) for name in cases] \
        + [(name, True) for name in ("inference", "refinement")]
    for name, fused in runs:
        get, args = cases[name]
        grads, R = {}, None
        for tag, model in (("kernels", kern), ("plain", plain)):
            stage = get(model).train()
            stage.zero_grad(set_to_none=True)
            inputs = [a.clone().requires_grad_(a.is_floating_point())
                      for a in args]
            if tag == "kernels":
                _native.reset_launch_counts()
            with fused_pos() if fused else contextlib.nullcontext():
                out = stage(*inputs)
                out = out[0] if isinstance(out, tuple) else out
                if R is None:
                    R = rand(*out.shape,
                             scale=(out.numel() / out.shape[-1]) ** -0.5)
                (out * R).sum().backward()
            torch.cuda.synchronize()
            grads[tag] = {f"{name}.{k}": p.grad for k, p in stage.named_parameters()}
            grads[tag].update({f"{name}.input{i}": x.grad
                               for i, x in enumerate(inputs) if x.grad is not None})
            if tag == "kernels":
                launches = _native.launch_counts()
        if not any(launches.values()):
            fail(f"{name}: the stage gradient ran no kernel")
        if fused and (launches["window_attention_bwd"]
                      or not launches["window_attention_pos_bwd"]):
            fail(f"{name} with NMRF_FUSED_POS=1: launches {launches}")
        key = f"{name} NMRF_FUSED_POS=1" if fused else name
        worst = max(check_close(f"{key} gradient {k}", grads["kernels"][k], g,
                                "float32")
                    for k, g in grads["plain"].items())
        report[key] = {"max_abs_err": worst, "leaves": len(grads["plain"]),
                        "launches": {k: v for k, v in launches.items() if v}}
        kern.zero_grad(set_to_none=True)
        plain.zero_grad(set_to_none=True)
    return report


def swin_grad_phase():
    """Phase 4b: float32 parameter gradients of the swin backbone and
    deformable neck (``SwinAdaptor`` in train mode, one pair at the
    training crop, 384x768: batch 2 through the backbone) through B5 and B5b
    (``TapLevel`` on the kernels) against the same modules on the plain
    versions, identical weights and inputs; drop-path is on, both models
    drawing the same masks (their generators reseeded alike).  The
    cotangents are N(0, 1) / sqrt(output rows), so every gradient is of
    order one: atol = rtol = 1e-4."""
    import torch

    from nmrf_tpu_torch import build_model
    from nmrf_tpu_torch.ops import _native

    kern = build_model(main_path_cfg("float32", False, True, swin=True))
    plain = build_model(main_path_cfg("float32", False, False, swin=True))
    plain.load_state_dict(kern.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(6)
    H, W = 384, 768
    images = torch.rand(2, H, W, 3, generator=gen, device="cuda") * 255
    grads, cots, launches = {}, None, None
    for tag, model in (("kernels", kern), ("plain", plain)):
        net = model.backbone.train()
        model.drop_path_masks.generator.manual_seed(7)
        _native.reset_launch_counts()
        outs = net(images)
        if cots is None:
            cots = [torch.randn(o.shape, generator=gen, device="cuda")
                    * (o.numel() / o.shape[-1]) ** -0.5 for o in outs]
        sum((o.float() * c).sum() for o, c in zip(outs, cots)).backward()
        torch.cuda.synchronize()
        counts = _native.launch_counts()
        if tag == "kernels":
            launches = counts
        elif any(counts.values()):
            fail(f"swin backbone on the plain versions launched {counts}")
        grads[tag] = {k: p.grad for k, p in net.named_parameters()}
    _expect_launches(launches, "swin backbone gradient", msda_taps=4,
                     msda_taps_bwd=4)
    missing = [k for k, g in grads["plain"].items()
               if g is None or grads["kernels"][k] is None]
    if missing:
        fail(f"swin backbone: parameters without a gradient: {missing}")
    worst = max(check_close(f"swin backbone gradient {k}", grads["kernels"][k],
                            g, "float32")
                for k, g in grads["plain"].items())
    return {"max_abs_err": worst, "leaves": len(grads["plain"]),
            "launches": {k: v for k, v in launches.items() if v}}


# the training and evaluation entry point (phase 8)

ENTRY_TRAIN = "synthetic_16x384x768"   # 2 batches of 8 per epoch
ENTRY_EVAL = "synthetic_2x375x1242"    # KITTI size: padded to 376x1248, bucketed
ENTRY_OPTS = [
    "DATASETS.TRAIN", f"('{ENTRY_TRAIN}',)",
    "DATASETS.TEST", f"['{ENTRY_EVAL}']",
    "DATASETS.CROP_SIZE", "(384, 768)",
    "SOLVER.IMS_PER_BATCH", "8",
    "TPU.COMPUTE_DTYPE", "bfloat16",
    "TEST.EVAL_PERIOD", "0",
    "SOLVER.LATEST_CHECKPOINT_PERIOD", "3",
]


def _step_dirs(path):
    return sorted(n for n in os.listdir(path) if n.startswith("step_"))


def _same_state(a, b):
    """Two saved training states equal bit for bit: the model, AdamW's
    moments and steps, the drop-path generator, the step."""
    import torch

    def same(x, y):
        if torch.is_tensor(x):
            return torch.is_tensor(y) and x.dtype == y.dtype and \
                x.shape == y.shape and torch.equal(x, y)
        if isinstance(x, dict):
            return isinstance(y, dict) and x.keys() == y.keys() and \
                all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        return x == y

    return {k: same(a[k], b.get(k)) for k in a}


def photometric_phase():
    """Phase 8b: the host photometric kernel (``nmrf_tpu_torch/native``)
    against its PIL plain version on a 375x1242 image: exact on brightness,
    contrast, saturation and gamma, within the bound of
    ``tests/test_native_photometric.py`` on hue and on the fused chain."""
    import ctypes
    import random

    try:
        from PIL import Image, ImageEnhance
    except ImportError:
        log("phase 8 photometric: PIL is not installed on this machine; the "
            "native kernel is not held against its PIL version here")
        return {"skipped": "PIL not installed"}
    from nmrf_tpu_torch import native
    from nmrf_tpu_torch.data import transforms as T

    lib = native.load()
    img = np.random.RandomState(7).randint(0, 256, (H_KITTI, W_KITTI, 3),
                                           dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def run(codes, b=1.0, c=1.0, s=1.0, hue=0, lut=None):
        out = img.copy()
        codes = np.asarray(codes, np.int32)
        table = np.arange(256, dtype=np.uint8) if lut is None else lut
        lib.nmrf_photometric(out.ctypes.data_as(u8p), out.size // 3,
                             codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                             len(codes), b, c, s, hue,
                             table.ctypes.data_as(u8p), int(lut is not None))
        return out

    pil = Image.fromarray(img)
    exact = {
        "brightness": (run([0], b=0.73),
                       ImageEnhance.Brightness(pil).enhance(0.73)),
        "contrast": (run([1], c=1.39), ImageEnhance.Contrast(pil).enhance(1.39)),
        "saturation": (run([2], s=0.6), ImageEnhance.Color(pil).enhance(0.6)),
        "gamma": (run([], lut=T._gamma_lut(1.73, 1.1)),
                  T._adjust_gamma(pil, 1.73, 1.1)),
    }
    report = {}
    for name, (got, want) in exact.items():
        n = int((got != np.asarray(want)).sum())
        report[name] = n
        if n:
            fail(f"photometric {name}: {n} values differ from PIL")
    hue = run([3], hue=int(round(0.09 * 255))).astype(np.int32)
    ref = np.asarray(T._adjust_hue(pil, 0.09)).astype(np.int32)
    report["hue_max_diff"] = int(np.abs(hue - ref).max())
    report["hue_mismatch"] = float((hue != ref).mean())
    if report["hue_max_diff"] > 8 or report["hue_mismatch"] >= 0.02:
        fail(f"photometric hue: {report}")
    jitter = T.ColorJitter(0.4, 0.4, (0.6, 1.4), 0.5 / 3.14)
    gamma = T.AdjustGamma(0.8, 1.2, 1.0, 1.02)
    random.seed(3)
    fused = T.fused_photometric(img, jitter, gamma).astype(np.int32)
    random.seed(3)
    plain = T.fused_photometric(img, jitter, gamma, plain=True).astype(np.int32)
    report["fused_max_diff"] = int(np.abs(fused - plain).max())
    report["fused_mismatch"] = float((fused != plain).mean())
    if report["fused_max_diff"] > 12 or report["fused_mismatch"] >= 0.05:
        fail(f"photometric fused chain: {report}")
    return report


DIAG_STEPS = 20
_NUM = r"([-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?|nan|inf)"


def diagnostics_phase():
    """Phase 8: the convergence-gate diagnostics through their ``main`` at
    full width, stdout captured: ``tools.probe_costvolume_signal`` (one seed
    of each kind at 192x384, bf16, the backbone and the correlation only)
    and ``tools.debug_convergence`` (the default config's overfit probe at
    its recipe, crop 384x768, batch 8, bf16, REMAT, for DIAG_STEPS steps).
    Their lines must parse with finite numbers, the probe's accuracies lie
    in [0, 1] with the exact bin's at most the within-1's, and the overfit
    probe launches K1 and K2 20 times a step (REMAT runs each layer's
    forward again in the backward) and 10 times in each of its 2
    evaluations, K1b and K2b 10 times a step."""
    import re

    from nmrf_tpu_torch.tools import debug_convergence, probe_costvolume_signal

    report = {}
    t0 = time.perf_counter()
    result, lines, counts = run_entry(probe_costvolume_signal.main,
                                      ["--seeds", "1"], "probe_costvolume_signal",
                                      "phase 8")
    for kind in probe_costvolume_signal.KINDS:
        hit = [re.fullmatch(rf"{kind}: raw cost-volume argmax exact-bin acc "
                            rf"{_NUM}, within-1-bin {_NUM}", line)
               for line in lines]
        hit = [m for m in hit if m]
        if len(hit) != 1:
            fail(f"probe_costvolume_signal: no line for {kind}: {lines}")
        acc, acc1 = (float(x) for x in hit[0].groups())
        if not 0.0 <= acc <= acc1 <= 1.0:
            fail(f"probe_costvolume_signal {kind}: accuracies {acc}, {acc1}")
        report[kind] = {"exact_bin": acc, "within_1_bin": acc1}
    report["probe_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    result, lines, counts = run_entry(
        debug_convergence.main, ["--steps", str(DIAG_STEPS)],
        "debug_convergence", "phase 8")
    stats = r"\[(init 0|overfit {})\] disp: mean {n} std {n} min {n} max {n} " \
        r"EPE {n}  initial_proposal_bestEPE {n} initial_proposal\[mean {n} " \
        r"max {n}\]  proposal_bestEPE {n} proposal\[mean {n} max {n}\]"
    patterns = [rf"GT disp stats: mean {_NUM} std {_NUM} max {_NUM}",
                stats.format(DIAG_STEPS, n=_NUM),
                rf"step {DIAG_STEPS}: lr {_NUM} \{{.*'total': {_NUM}.*\}}",
                stats.format(DIAG_STEPS, n=_NUM),
                r"avg (\d+) ms/step"]
    if len(lines) != len(patterns):
        fail(f"debug_convergence: {len(lines)} lines, expected "
             f"{len(patterns)}: {lines}")
    for line, pattern in zip(lines, patterns):
        m = re.fullmatch(pattern, line)
        if not m or not all(np.isfinite(float(x)) for x in m.groups()
                            if x and not x.startswith(("init ", "overfit "))):
            fail(f"debug_convergence: line {line!r} does not parse with "
                 "finite numbers")
    _expect_launches(counts, f"debug_convergence, {DIAG_STEPS} steps and 2 "
                     "evaluations",
                     window_attention=20 * DIAG_STEPS + 20,
                     stripe_attention=20 * DIAG_STEPS + 20,
                     window_attention_bwd=10 * DIAG_STEPS,
                     stripe_attention_bwd=10 * DIAG_STEPS)
    report["overfit"] = {"lines": lines, "ms_per_step": result["ms_per_step"],
                         "launches": counts,
                         "seconds": time.perf_counter() - t0}
    return report


def entry_point_phase():
    """Phase 8: ``nmrf_tpu_torch.train.main``, the CLI, in this process at
    full width (default resnet config, bf16, batch 8, 384x768 synthetic
    pairs), deterministic (``utils.misc.deterministic``): run A trains 6
    steps into D and keeps step 3 and 6; run C resumes a copy of D's step 3
    to step 6 and must save the same state bit for bit; run B resumes D to
    step 9 with ``CHECKPOINT_PERIOD 100``, continuing the step count, and
    pruning leaves only step 9; an ``--eval-only`` run evaluates D's last
    checkpoint on 2 KITTI-size pairs.  K1, K2, K1b and K2b must launch in
    these runs, as many times as their steps and frames take."""
    import shutil
    import tempfile

    import torch

    from nmrf_tpu_torch import train as cli
    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.utils.checkpoint import restore_checkpoint
    from nmrf_tpu_torch.utils.misc import deterministic

    work = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    d, dc, de = (os.path.join(work, n) for n in ("D", "C", "E"))
    report = {}
    try:
        with deterministic():
            _native.reset_launch_counts()
            a = cli.main(["--checkpoint-dir", d] + ENTRY_OPTS + [
                "SOLVER.MAX_ITER", "6", "SOLVER.CHECKPOINT_PERIOD", "3"])
            if a["step"] != 6 or _step_dirs(d) != ["step_00000003",
                                                   "step_00000006"]:
                fail(f"run A: step {a['step']}, saves {_step_dirs(d)}")
            for row in a["losses"]:
                if not all(np.isfinite(v) for v in row.values()):
                    fail(f"run A: non-finite losses {row}")
            report["A"] = {"losses": [{k: r[k] for k in ("step", "total")}
                                      for r in a["losses"]], **a["timing"]}

            os.makedirs(dc)
            shutil.copytree(os.path.join(d, "step_00000003"),
                            os.path.join(dc, "step_00000003"))
            with open(os.path.join(dc, "latest.txt"), "w") as f:
                f.write("3")
            c = cli.main(["--checkpoint-dir", dc] + ENTRY_OPTS + [
                "SOLVER.MAX_ITER", "6", "SOLVER.CHECKPOINT_PERIOD", "3",
                "SOLVER.RESUME", dc])
            same = _same_state(restore_checkpoint(d, 6)[0],
                               restore_checkpoint(dc, 6)[0])
            report["C"] = {"step": c["step"], "same_state_as_A": same,
                           **c["timing"]}
            if c["step"] != 6 or not all(same.values()):
                fail(f"run C (steps 4-6 again from step 3): step {c['step']}, "
                     f"the saved state equal to run A's: {same}")

            b = cli.main(["--checkpoint-dir", d] + ENTRY_OPTS + [
                "SOLVER.MAX_ITER", "9", "SOLVER.CHECKPOINT_PERIOD", "100",
                "SOLVER.RESUME", d])
            left = sorted(os.listdir(d))
            report["B"] = {"step": b["step"], "first_logged_step":
                           b["losses"][0]["step"], "left": left, **b["timing"]}
            if b["step"] != 9 or b["losses"][0]["step"] != 7 or \
                    _step_dirs(d) != ["step_00000009"] or "latest.txt" not in left:
                fail(f"run B (resume 6 -> 9, pruned): {report['B']}")

            e = cli.main(["--checkpoint-dir", de, "--eval-only"] + ENTRY_OPTS
                         + ["SOLVER.RESUME", d])
            res = e["results"]["disp"]
            with open(os.path.join(de, "log.txt")) as f:
                logged = [line for line in f if "copypaste:" in line]
            report["eval"] = {"results": res, "copypaste_lines": len(logged),
                              **e["timing"]}
            if not np.isfinite(res["epe"]) or not logged:
                fail(f"--eval-only: {report['eval']}")
            counts, variants = _native.launch_counts(), _native.variant_counts()
        steps, frames = 6 + 3 + 3, 2
        _expect_launches(counts, f"{steps} CLI steps and {frames} eval frames",
                         window_attention=10 * (steps + frames),
                         stripe_attention=10 * (steps + frames),
                         window_attention_bwd=10 * steps,
                         stripe_attention_bwd=10 * steps)
        report["launches"] = counts
        report["variants"] = variants
        report["ms_per_step"] = {k: report[k]["train_s"] / report[k]["steps"] * 1e3
                                 for k in ("A", "B", "C")}
        report["save_s"] = (report["A"]["save_s"] + report["C"]["save_s"]
                            + report["B"]["save_s"]) / (
            report["A"]["saves"] + report["C"]["saves"] + report["B"]["saves"])
        report["restore_s"] = {k: report[k]["restore_s"] for k in ("B", "C", "eval")}
        report["eval_ms_per_frame"] = (report["eval"]["eval_s"]
                                       / report["eval"]["eval_frames"] * 1e3)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    report["photometric"] = photometric_phase()
    return report


# --------------------------------------------------------------------------- #
# the H-sharded path (phase 7): two ranks on the one card
# --------------------------------------------------------------------------- #

SHARD_GRID = (1, 2)   # (data, spatial)
SHARD_DIVIS = 96      # each tile's 1/8 rows (24) hold whole 6-row windows
SHARD_TRAIN_STEPS = 5


def sharded_phase(grid=SHARD_GRID, backend="gloo"):
    """Phase 7: spawn the ranks of a (data, spatial) grid, rank r on card
    r % device count (the default: two ranks on the one card over gloo,
    since NCCL refuses two ranks on one device), wait for them; returns
    each rank's report.  A failing rank fails the run."""
    import tempfile

    from nmrf_tpu_torch.parallel import spawn

    out = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    world = grid[0] * grid[1]
    spawn(sharded_worker, world, backend, args=(out, tuple(grid), backend),
          timeout_s=600)
    reports = []
    for rank in range(world):
        with open(f"{out}/rank{rank}.json") as f:
            reports.append(json.load(f))
    return reports


def sharded_worker(rank, out_dir, grid, backend):
    """One rank of phase 7 (its own process, torch.distributed initialised)."""
    import torch

    from nmrf_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*grid, backend=backend)
    report = {"rank": rank, "device": str(mesh.device),
              "device_name": torch.cuda.get_device_name(mesh.device)}
    for name, fn in (("serve", sharded_serve), ("parity", sharded_parity),
                     ("grad_check", sharded_grad_check),
                     ("backbone", sharded_backbone),
                     ("swin_backbone", sharded_swin_backbone),
                     ("train", sharded_train),
                     ("train_fused_pos", lambda m: sharded_train(m, fused=True)),
                     ("swin_serve", sharded_swin_serve),
                     ("swin_grad_check", lambda m: sharded_grad_check(m, swin=True)),
                     ("swin_train", sharded_swin_train)):
        report[name] = fn(mesh)
        torch.cuda.empty_cache()
        if rank == 0:
            log(f"phase 7 sharded {name} (rank 0): " + json.dumps(report[name]))
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(report, f)


def log_sharded_swin(reports):
    """Phase 7's per-rank lines: the resnet stem's rows (the backbone on
    tiles), the backbone's tile and whole-image times, B5 and B5b launches
    of the sharded swin requests and steps, the swin steps' losses."""
    for r in reports:
        log(f"phase 7 rank {r['rank']}: resnet stem rows "
            + json.dumps(r["parity"]["backbone_stem_rows"])
            + "; backbone " + json.dumps(r["backbone"])
            + "; swin backbone " + json.dumps(r["swin_backbone"])
            + "; swin B5 launches in requests "
            + str(r["swin_serve"]["launches"]["msda_taps"])
            + ", B5/B5b in steps " + str(r["swin_train"]["launches"]["msda_taps"])
            + "/" + str(r["swin_train"]["launches"]["msda_taps_bwd"])
            + "; swin f32 step vs unsharded "
            + json.dumps({k: r["swin_grad_check"].get(k) for k in
                          ("loss_rel_err", "grad_rel_err")})
            + "; swin steps " + json.dumps(r["swin_train"]["losses"]))


def _expect_launches(counts, what, **want):
    full = dict.fromkeys(counts, 0)
    full.update(want)
    if counts != full:
        fail(f"{what}: launches {counts}, expected {full}")


def sharded_serve(mesh):
    """KITTI requests through make_sharded_forward (bf16, tanh GELU), padded
    to SHARD_DIVIS; per rank per frame 10 K1, 5 K2 and 5 B6 launches."""
    import torch
    import torch.distributed as dist

    from nmrf_tpu_torch import build_model
    from nmrf_tpu_torch.data.frame_io import InputPadder
    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.parallel import make_sharded_forward

    model = build_model(main_path_cfg("bfloat16", True, True,
                                      grid=(mesh.data, mesh.spatial)), mesh=mesh)
    fwd = make_sharded_forward(model, mesh)
    rng = np.random.RandomState(0)
    pairs = [((rng.rand(H_KITTI, W_KITTI, 3) * 255).astype(np.float32),
              (rng.rand(H_KITTI, W_KITTI, 3) * 255).astype(np.float32))
             for _ in range(REQUESTS + 1)]

    def request(img1, img2):
        padder = InputPadder(img1.shape, mode="proposal", divis_by=SHARD_DIVIS)
        a, b = (torch.from_numpy(p[None]).to(mesh.device)
                for p in padder.pad(img1, img2))
        return padder.unpad(fwd(a, b)["disp"].float().cpu().numpy())[0]

    request(*pairs[0])  # warm-up
    dist.barrier()
    # one profiled request: rank 0 under torch.profiler, rank 1 alongside
    if mesh.rank == 0:
        profile = profile_phase("sharded request (rank 0)",
                                lambda: request(*pairs[1]))
    else:
        request(*pairs[1])
        profile = None
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host_ms, disps = [], []
    start.record()
    for img1, img2 in pairs[1:]:
        t = time.perf_counter()
        disps.append(request(img1, img2))
        host_ms.append((time.perf_counter() - t) * 1e3)
    end.record()
    torch.cuda.synchronize()
    counts = _native.launch_counts()
    for d in disps:
        if d.shape != (H_KITTI, W_KITTI) or not np.isfinite(d).all() or (d < 0).any():
            fail(f"sharded disparity: shape {d.shape}, not finite and non-negative")
    _expect_launches(counts, f"rank {mesh.rank}, {REQUESTS} sharded requests",
                     window_attention=10 * REQUESTS,
                     stripe_attention=5 * REQUESTS,
                     masked_attention=5 * REQUESTS)
    return {"requests": REQUESTS, "padded": [384, 1248],
            "frame_ms": start.elapsed_time(end) / REQUESTS, "profile": profile,
            "host_request_ms": host_ms, "launches": counts,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "disp_mean": float(np.mean([d.mean() for d in disps]))}


def sharded_parity(mesh):
    """The f32 sharded forward (kernels) against the unsharded forward
    (kernels) on the same weights and a 384x1248 pair, on rank 0: prob and
    proposals strict, disparity tie-aware (``check_forward``)."""
    import torch
    import torch.distributed as dist

    from nmrf_tpu_torch import build_model
    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.parallel import make_sharded_forward

    cfg = main_path_cfg("float32", False, True, grid=(mesh.data, mesh.spatial))
    model = build_model(cfg, mesh=mesh)
    rng = np.random.RandomState(1)
    img1, img2 = (torch.from_numpy((rng.rand(1, 384, 1248, 3) * 255).astype(
        np.float32)).to(mesh.device) for _ in range(2))
    stem = []  # the rows of the backbone stem's input and output
    handle = model.backbone.conv1.register_forward_hook(
        lambda _m, inputs, out: stem.append((inputs[0].shape[1], out.shape[1])))
    _native.reset_launch_counts()
    got = make_sharded_forward(model, mesh)(img1, img2)
    torch.cuda.synchronize()
    handle.remove()
    tile = 384 // mesh.spatial
    if stem != [(tile, tile // 2)]:
        fail(f"rank {mesh.rank}: the resnet stem took {stem} rows (input, "
             f"output), expected its tile of {tile} image rows")
    report = {"launches": _native.launch_counts(),
              "backbone_stem_rows": {"image": 384, "input": stem[0][0],
                                     "output": stem[0][1]}}
    _expect_launches(report["launches"], f"rank {mesh.rank}, f32 sharded forward",
                     window_attention=10, stripe_attention=5,
                     masked_attention=5)
    if mesh.rank == 0:
        ref_model = build_model(cfg, device=mesh.device)
        ref_model.load_state_dict(model.state_dict())
        scores = {}
        handle = ref_model.infer_score_head.register_forward_hook(
            lambda _m, _i, out: scores.update(plain=out))
        with torch.inference_mode():
            ref = ref_model(img1, img2)
        handle.remove()
        report.update(check_forward(got, ref, scores["plain"][-1]))
        del ref_model, ref, scores
    dist.barrier()
    return report


# leaves whose gradient is zero in exact arithmetic (a key bias shifts a
# softmax row by one value; the proposal score head's bias shifts every
# candidate's logit of a sub-pixel alike; the DPN cost filter's last bias
# shifts all D logits of its softmax alike): their error is normalised by
# the gradient scale of their layer, as the backbone's by the backbone's
ZERO_GRAD_LEAVES = ("k.bias", "infer_score_head.bias", "dpn.mlp.4.bias")
SWIN_GRAD_BATCH = 2


def sharded_grad_check(mesh, swin=False):
    """One f32 step's losses and gradients, sharded (world-summed) against
    unsharded (rank 0), same weights and batch (crop 384x768, batch 8):
    losses at rtol 1e-4, every gradient leaf at the tolerances of
    ``tests/test_spatial_model.py:95-119`` (backbone leaves: |d| / max |g|
    over the backbone < 1e-2; the others |d| / (max |g_leaf| + 1e-6) <
    5e-3).  ``swin``: the swin model at batch SWIN_GRAD_BATCH, drop-path
    on: both sides draw the same masks (one generator seeded alike, the
    global batch's draw on each side), 4 B5 and 4 B5b launches more."""
    import torch
    import torch.distributed as dist

    from nmrf_tpu_torch import build_criterion, build_model
    from nmrf_tpu_torch.data import synthetic_batch
    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.parallel import (shard_batch, spatial_sharded_apply,
                                         sum_gradients)

    cfg = main_path_cfg("float32", False, True, swin=swin,
                        grid=(mesh.data, mesh.spatial))
    criterion = build_criterion(cfg)
    H, W = cfg.DATASETS.CROP_SIZE
    B = SWIN_GRAD_BATCH if swin else TRAIN_BATCH
    batch = synthetic_batch(B, H, W, max_disp=cfg.SOLVER.MAX_DISP,
                            seed=0, disp_quantum=8)
    report = {"batch": B, "crop": [H, W]}
    if mesh.rank == 0:
        torch.cuda.reset_peak_memory_stats()
        ref = build_model(cfg, device=mesh.device).train()
        tb = {k: torch.from_numpy(v).to(mesh.device) for k, v in batch.items()}
        losses = criterion(ref(tb["img1"], tb["img2"]), tb)
        losses["total"].backward()
        want_losses = {k: float(v.detach()) for k, v in losses.items()}
        want = {n: p.grad.detach().clone() for n, p in ref.named_parameters()
                if p.grad is not None}
        report["unsharded_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del ref, tb, losses
        torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, mesh=mesh).train()
    local = shard_batch(batch, mesh)
    _native.reset_launch_counts()
    losses = criterion(spatial_sharded_apply(model, mesh, local["img1"],
                                             local["img2"]), local)
    losses["total"].backward()
    sum_gradients(list(model.parameters()), mesh)
    torch.cuda.synchronize()
    report["launches"] = _native.launch_counts()
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    taps = {"msda_taps": 4, "msda_taps_bwd": 4} if swin else {}
    _expect_launches(report["launches"], f"rank {mesh.rank}, f32 sharded step"
                     + (" (swin)" if swin else ""),
                     window_attention=10, stripe_attention=5,
                     masked_attention=5, window_attention_bwd=10,
                     stripe_attention_bwd=5, masked_attention_bwd=5, **taps)
    if mesh.rank == 0:
        got_losses = {k: float(v.detach()) for k, v in losses.items()}
        report["loss_rel_err"] = max(abs(got_losses[k] - v) / max(abs(v), 1e-12)
                                     for k, v in want_losses.items())
        if report["loss_rel_err"] > 1e-4:
            fail(f"sharded losses {got_losses} vs unsharded {want_losses}")
        got = {n: p.grad for n, p in model.named_parameters()
               if p.grad is not None}
        if got.keys() != want.keys():
            fail("sharded and unsharded steps give gradients of other leaves")
        bb = max(g.abs().max().item() for n, g in want.items()
                 if n.startswith("backbone."))
        worst = {"backbone": 0.0, "other": 0.0}
        for n, g in want.items():
            d = (got[n] - g).abs().max().item()
            if n.startswith("backbone."):
                err, kind, limit = d / bb, "backbone", 1e-2
            elif n.endswith(ZERO_GRAD_LEAVES):
                layer = n.rsplit(".", 1)[0] + "."
                scale = max(v.abs().max().item() for k, v in want.items()
                            if k.startswith(layer))
                err, kind, limit = d / (scale + 1e-6), "other", 5e-3
            else:
                err = d / (g.abs().max().item() + 1e-6)
                kind, limit = "other", 5e-3
            worst[kind] = max(worst[kind], err)
            if err >= limit:
                fail(f"sharded gradient {n}: relative error {err:.3e} >= {limit}")
        report["grad_rel_err"] = worst
        report["losses"] = got_losses
    dist.barrier()
    return report


def sharded_train(mesh, fused=False):
    """A warm-up, a profiled and SHARD_TRAIN_STEPS timed sharded training
    steps (bf16, exact GELU, crop 384x768, batch 8) through
    make_train_step(..., mesh=); per rank per
    step 10 K1 + 10 K1b, 5 K2 + 5 K2b, 5 B6 + 5 B6b; the loss falls and the
    ranks keep identical parameters.  ``fused``: the same inside
    ``fused_pos()``, 10 B7 and no K1b per rank and step, no profiled step."""
    with fused_pos() if fused else contextlib.nullcontext():
        return _sharded_train(mesh, fused)


def _sharded_train(mesh, fused):
    import torch
    import torch.distributed as dist

    from nmrf_tpu_torch import (build_criterion, build_model, build_optimizer,
                                make_train_step)
    from nmrf_tpu_torch.data import synthetic_batch
    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.parallel import shard_batch

    cfg = main_path_cfg("bfloat16", False, True, grid=(mesh.data, mesh.spatial))
    model = build_model(cfg, mesh=mesh)
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg.SOLVER.ACCUM_STEPS, grad_clip=cfg.SOLVER.GRAD_CLIP,
                           mesh=mesh)
    H, W = cfg.DATASETS.CROP_SIZE
    batch = shard_batch(synthetic_batch(TRAIN_BATCH, H, W,
                                        max_disp=cfg.SOLVER.MAX_DISP, seed=0,
                                        disp_quantum=8), mesh)
    history = [step(batch)]  # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    profile = None
    if fused:
        history.append(step(batch))
    elif mesh.rank == 0:  # one profiled step, rank 1 alongside
        profile = profile_phase("sharded train step (rank 0)",
                                lambda: history.append(step(batch)))
    else:
        history.append(step(batch))
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    history += [step(batch) for _ in range(SHARD_TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    counts = _native.launch_counts()
    S = SHARD_TRAIN_STEPS
    window_bwd = "window_attention_pos_bwd" if fused else "window_attention_bwd"
    _expect_launches(counts, f"rank {mesh.rank}, {S} sharded steps"
                     + (" (NMRF_FUSED_POS=1)" if fused else ""),
                     window_attention=10 * S, stripe_attention=5 * S,
                     masked_attention=5 * S, stripe_attention_bwd=5 * S,
                     masked_attention_bwd=5 * S, **{window_bwd: 10 * S})
    rows = [{k: float(v) for k, v in h.items()} for h in history]
    if not all(np.isfinite(v) for row in rows for v in row.values()):
        fail(f"sharded training: non-finite loss or gradient norm {rows}")
    first, last = rows[0]["total"], float(np.mean([r["total"] for r in rows[-2:]]))
    if not last < first:
        fail(f"sharded training: loss did not fall ({first:.4f} at the first "
             f"step, {last:.4f} over the last 2)")
    # the world-summed update keeps the ranks' parameters identical
    checksum = torch.stack([p.detach().double().sum() for p in model.parameters()])
    sums = mesh.world.all_gather(checksum, "check")
    if not all(torch.equal(sums[0], s) for s in sums[1:]):
        fail("sharded training: the ranks' parameters diverged")
    return {"fused_pos": fused, "batch": TRAIN_BATCH, "crop": [H, W], "steps": S,
            "step_ms": start.elapsed_time(end) / S, "profile": profile,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts, "total_first": first, "total_last2": last,
            "losses": [{k: r[k] for k in ("total", "epe_train", "grad_norm")}
                       for r in rows]}


BACKBONE_ITERS = 5


def sharded_backbone(mesh):
    """The resnet backbone's part of a sharded training step on every rank
    (bf16, crop 384x768, batch 8): the forward through ``sharded_features``
    (the rank's H tile of its images with halo rows, global instance-norm
    moments) and the backward of sum(features * cotangent), against the
    same on the whole images of the rank's data shard with the rank's tile
    of the features kept (the unsharded backbone of the same weights: what
    a rank ran before the backbone was sharded).  Each is timed with CUDA
    events over BACKBONE_ITERS calls after a warm-up, both ranks working
    at once, and profiled once on rank 0, where the profile holds the
    backbone's kernels alone (convolution, instance norm, elementwise, the
    halo copies): its device busy ms is the rank's backbone device time."""
    import torch
    import torch.distributed as dist

    from nmrf_tpu_torch import build_model
    from nmrf_tpu_torch.data import synthetic_batch
    from nmrf_tpu_torch.parallel.mesh import sharded_features

    cfg = main_path_cfg("bfloat16", False, True, grid=(mesh.data, mesh.spatial))
    model = build_model(cfg, mesh=mesh).train()
    whole = build_model(cfg, device=mesh.device).train()
    whole.load_state_dict(model.state_dict())
    H, W = cfg.DATASETS.CROP_SIZE
    n = TRAIN_BATCH // mesh.data
    batch = synthetic_batch(TRAIN_BATCH, H, W, max_disp=cfg.SOLVER.MAX_DISP,
                            seed=0, disp_quantum=8)
    img1, img2 = (torch.from_numpy(batch[k][mesh.data_index * n:
                                            (mesh.data_index + 1) * n]
                                   ).to(mesh.device) for k in ("img1", "img2"))
    sp = mesh.spatial_group

    def tile(f):
        h = f.shape[1] // mesh.spatial
        return f.narrow(1, sp.index * h, h)

    def run(features):
        f1, f2 = features()
        sum(f.float().sum() for f in f1 + f2).backward()

    forms = {"tile": lambda: sharded_features(model, mesh, img1, img2),
             "whole": lambda: [[tile(f) for f in fs] for fs in
                               whole.extract_feature(img1, img2)]}
    report = {"batch_per_rank": n, "crop": [H, W]}
    for name, features in forms.items():
        run(features)  # warm-up: cuDNN's choices
        torch.cuda.synchronize()
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BACKBONE_ITERS):
            run(features)
        end.record()
        torch.cuda.synchronize()
        dist.barrier()
        row = {"event_ms": start.elapsed_time(end) / BACKBONE_ITERS}
        if mesh.rank == 0:
            prof = profile_phase(f"sharded backbone, {name} (rank 0)",
                                 lambda: run(features))
            row.update(device_busy_ms=prof["device_busy_ms"],
                       groups={g["group"]: g["ms"] for g in prof["groups"]})
        else:
            run(features)
        dist.barrier()
        report[name] = row
    return report


def sharded_swin_backbone(mesh):
    """The swin backbone (Swin-T and the deformable neck) on the rank's H
    tile of its images (``sharded_features``: windows completed from the
    neighbour tiles, stages too short for a tile run whole, the neck's
    value maps exchanged for the rows its taps reach) against the whole
    images of the rank's data shard with the tile's rows kept (what a rank
    ran before the backbone was tiled), the same weights on both sides:

    * f32, SWIN_GRAD_BATCH pairs (drop-path on, both sides drawing the same
      masks): each level's tile of both views against the whole-image rows
      (atol 1e-3 at values up to about 10: cuDNN and cuBLAS take other
      algorithms at the two shapes), the gradients of the tiles' feature
      sums, summed over the spatial group, against those of the whole
      image's feature sum (|d| / max |g| over the backbone < 1e-2, the CPU
      test's), 4 B5 and 4 B5b launches a rank on the tile;
      the stem's and the patch embedding's inputs must be the tile's rows;
      the stages that ran on tiles and the collectives by site;
    * bf16, crop 384x768, TRAIN_BATCH pairs per data index: forward and the
      backward of sum(features), each form timed with CUDA events over
      BACKBONE_ITERS calls after a warm-up (both ranks at once), its peak
      memory, and profiled once on rank 0 (device busy ms: the backbone's
      kernels alone)."""
    import torch
    import torch.distributed as dist

    from nmrf_tpu_torch import build_model
    from nmrf_tpu_torch.data import synthetic_batch
    from nmrf_tpu_torch.models.layers import DropPathMasks, set_drop_path_masks
    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.parallel.mesh import sharded_features

    sp = mesh.spatial_group
    report = {}
    for dtype in ("float32", "bfloat16"):
        cfg = main_path_cfg(dtype, False, True, swin=True,
                            grid=(mesh.data, mesh.spatial))
        model = build_model(cfg, mesh=mesh).train()
        whole = build_model(cfg, device=mesh.device).train()
        whole.load_state_dict(model.state_dict())
        whole.drop_path_masks = DropPathMasks(
            torch.Generator(device=mesh.device), mesh.data_index, mesh.data)
        set_drop_path_masks(whole, whole.drop_path_masks)
        H, W = cfg.DATASETS.CROP_SIZE
        pairs = (SWIN_GRAD_BATCH if dtype == "float32" else TRAIN_BATCH)
        n = pairs // mesh.data
        batch = synthetic_batch(pairs, H, W, max_disp=cfg.SOLVER.MAX_DISP,
                                seed=0, disp_quantum=8)
        img1, img2 = (torch.from_numpy(batch[k][mesh.data_index * n:
                                                (mesh.data_index + 1) * n]
                                       ).to(mesh.device) for k in ("img1", "img2"))

        def tile(f):
            h = f.shape[1] // mesh.spatial
            return f.narrow(1, sp.index * h, h)

        forms = {"tile": (model, lambda: sharded_features(model, mesh, img1,
                                                          img2)),
                 "whole": (whole, lambda: [[tile(f) for f in fs] for fs in
                                           whole.extract_feature(img1, img2)])}

        def run(form):
            net, features = forms[form]
            net.drop_path_masks.generator.manual_seed(0)
            f1, f2 = features()
            sum(f.float().sum() for f in f1 + f2).backward()
            return f1, f2

        if dtype == "float32":
            rows = []
            hooks = [m.register_forward_hook(
                lambda _m, inputs, _out: rows.append(inputs[0].shape[1]))
                for m in (model.backbone.neck.stem.stem["0"],
                          model.backbone.backbone.patch_embed)]
            mesh.counts.reset()
            _native.reset_launch_counts()
            got = run("tile")
            torch.cuda.synchronize()
            counts, comm = _native.launch_counts(), mesh.counts.summary()
            for h in hooks:
                h.remove()
            if rows != [H // mesh.spatial] * 2:
                fail(f"rank {mesh.rank}: the swin stem and patch embedding took "
                     f"{rows} rows, expected the tile's {H // mesh.spatial}")
            _expect_launches(counts, f"rank {mesh.rank}, the swin backbone on "
                             "its tile", msda_taps=4, msda_taps_bwd=4)
            names = [k for k, p in model.backbone.named_parameters()
                     if p.grad is not None]
            tiled = dict(model.backbone.named_parameters())
            total = sp.all_reduce(torch.cat([tiled[k].grad.reshape(-1)
                                             for k in names]), "check")
            # the whole image's gradient: of all its rows, the sum of the
            # tiles' losses over the group
            whole.drop_path_masks.generator.manual_seed(0)
            want = whole.extract_feature(img1, img2)
            sum(f.float().sum() for f in want[0] + want[1]).backward()
            worst = max((a.detach() - tile(b.detach())).abs().max().item()
                        for fa, fb in zip(got, want) for a, b in zip(fa, fb))
            ref = dict(whole.backbone.named_parameters())
            grads = torch.cat([ref[k].grad.reshape(-1) for k in names])
            grad_err = ((total - grads).abs().max() / grads.abs().max()).item()
            if worst > 1e-3 or grad_err > 1e-2:
                fail(f"rank {mesh.rank}: the swin backbone's tile vs the whole "
                     f"image: features {worst:.3e}, gradients {grad_err:.3e}")
            report["check"] = {
                "pairs_per_rank": n, "crop": [H, W], "launches": counts,
                "stem_rows": rows, "features_max_abs_err": worst,
                "grad_rel_err": grad_err,
                "stages_on_tiles": list(model.backbone.backbone.tiled),
                "collectives": comm}
            del got, want, total, grads
            model.zero_grad(set_to_none=True)
            whole.zero_grad(set_to_none=True)
            continue
        report["pairs_per_rank"], report["crop"] = n, [H, W]
        for form in forms:
            run(form)  # warm-up: cuDNN's choices
            torch.cuda.synchronize()
            dist.barrier()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(BACKBONE_ITERS):
                run(form)
            end.record()
            torch.cuda.synchronize()
            row = {"event_ms": start.elapsed_time(end) / BACKBONE_ITERS,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            dist.barrier()
            if mesh.rank == 0:
                prof = profile_phase(f"sharded swin backbone, {form} (rank 0)",
                                     lambda: run(form))
                row.update(device_busy_ms=prof["device_busy_ms"],
                           groups={g["group"]: g["ms"] for g in prof["groups"]})
            else:
                run(form)
            dist.barrier()
            report[form] = row
        del model, whole, forms
        torch.cuda.empty_cache()
    return report


SWIN_SHARD_REQUESTS = 2
SWIN_SHARD_STEPS = 3


def sharded_swin_serve(mesh):
    """The swin model (f32) on the grid: SWIN_SHARD_REQUESTS KITTI pairs
    padded to SHARD_DIVIS through make_sharded_forward, each held on rank 0
    against the unsharded forward of the same weights (``check_forward``);
    per rank per frame 4 B5 (the backbone on the rank's tile), 10 K1, 5 K2
    and 5 B6 launches."""
    import torch
    import torch.distributed as dist

    from nmrf_tpu_torch import build_model
    from nmrf_tpu_torch.data.frame_io import InputPadder
    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.parallel import make_sharded_forward

    cfg = main_path_cfg("float32", False, True, swin=True,
                        grid=(mesh.data, mesh.spatial))
    model = build_model(cfg, mesh=mesh)
    fwd = make_sharded_forward(model, mesh)
    ref_model = None
    if mesh.rank == 0:
        ref_model = build_model(cfg, device=mesh.device)
        ref_model.load_state_dict(model.state_dict())
    rng = np.random.RandomState(2)
    checks, counts = [], {}
    t0 = time.perf_counter()
    for _ in range(SWIN_SHARD_REQUESTS):
        pair = [(rng.rand(H_KITTI, W_KITTI, 3) * 255).astype(np.float32)
                for _ in range(2)]
        padder = InputPadder(pair[0].shape, mode="proposal",
                             divis_by=SHARD_DIVIS)
        a, b = (torch.from_numpy(p[None]).to(mesh.device)
                for p in padder.pad(*pair))
        _native.reset_launch_counts()  # the sharded forwards' launches only
        got = fwd(a, b)
        torch.cuda.synchronize()
        for k, v in _native.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        if mesh.rank == 0:
            scores = {}
            handle = ref_model.infer_score_head.register_forward_hook(
                lambda _m, _i, out: scores.update(plain=out))
            with torch.inference_mode():
                ref = ref_model(a, b)
            handle.remove()
            checks.append(check_forward(got, ref, scores["plain"][-1]))
        dist.barrier()
    R = SWIN_SHARD_REQUESTS
    _expect_launches(counts, f"rank {mesh.rank}, {R} sharded swin requests",
                     msda_taps=4 * R, window_attention=10 * R,
                     stripe_attention=5 * R, masked_attention=5 * R)
    return {"requests": R, "padded": [384, 1248], "dtype": "float32",
            "seconds": time.perf_counter() - t0, "launches": counts,
            "checks": checks}


def sharded_swin_train(mesh):
    """One warm-up and SWIN_SHARD_STEPS sharded swin training steps (bf16,
    drop-path 0.4, crop 384x768, batch 8) through make_train_step(...,
    mesh=, monitor_oob=True): per rank per step 4 B5 and 4 B5b (their
    vector kernels, B5b with its tap masks) beside 10 K1 + 10 K1b, 5 K2 +
    5 K2b, 5 B6 + 5 B6b; finite losses, ``msda_tap_oob`` every step and 0
    at init, and every rank the same losses and parameters."""
    import torch
    import torch.distributed as dist

    from nmrf_tpu_torch import (build_criterion, build_model, build_optimizer,
                                make_train_step)
    from nmrf_tpu_torch.data import synthetic_batch
    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.parallel import shard_batch

    cfg = main_path_cfg("bfloat16", False, True, swin=True,
                        grid=(mesh.data, mesh.spatial))
    model = build_model(cfg, mesh=mesh)
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg.SOLVER.ACCUM_STEPS, grad_clip=cfg.SOLVER.GRAD_CLIP,
                           mesh=mesh, monitor_oob=True)
    H, W = cfg.DATASETS.CROP_SIZE
    batch = shard_batch(synthetic_batch(TRAIN_BATCH, H, W,
                                        max_disp=cfg.SOLVER.MAX_DISP, seed=0,
                                        disp_quantum=8), mesh)
    history = [step(batch)]  # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    history += [step(batch) for _ in range(SWIN_SHARD_STEPS)]
    end.record()
    torch.cuda.synchronize()
    counts, variants = _native.launch_counts(), _native.variant_counts()
    S = SWIN_SHARD_STEPS
    _expect_launches(counts, f"rank {mesh.rank}, {S} sharded swin steps",
                     msda_taps=4 * S, msda_taps_bwd=4 * S,
                     window_attention=10 * S, window_attention_bwd=10 * S,
                     stripe_attention=5 * S, stripe_attention_bwd=5 * S,
                     masked_attention=5 * S, masked_attention_bwd=5 * S)
    if variants["msda_taps_bwd"] != {"vector_masks": 4 * S}:
        fail(f"rank {mesh.rank}: B5b variants {variants['msda_taps_bwd']}")
    rows = [{k: float(v) for k, v in h.items()} for h in history]
    if not all(np.isfinite(v) for row in rows for v in row.values()) or \
            [r.get("msda_tap_oob") for r in rows][0] != 0.0 or \
            any("msda_tap_oob" not in r for r in rows):
        fail(f"rank {mesh.rank}, sharded swin steps: {rows}")
    checksum = torch.stack([p.detach().double().sum() for p in model.parameters()]
                           + [torch.tensor(r[k], dtype=torch.float64,
                                           device=mesh.device)
                              for r in rows for k in ("total", "msda_tap_oob")])
    sums = mesh.world.all_gather(checksum, "check")
    if not all(torch.equal(sums[0], s) for s in sums[1:]):
        fail("sharded swin steps: the ranks' parameters, losses or "
             "msda_tap_oob differ")
    return {"batch": TRAIN_BATCH, "crop": [H, W], "steps": S,
            "step_ms": start.elapsed_time(end) / S,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts, "variants": variants,
            "losses": [{k: r[k] for k in ("total", "epe_train", "grad_norm",
                                          "msda_tap_oob")} for r in rows]}


SWIN_DATA_GRID = (2, 1)   # (data, spatial): the swin step, data-parallel
SWIN_DATA_STEPS = 2


def swin_data_phase():
    """Phase 7 for the swin variant: two ranks on the one card over gloo, a
    2 x 1 (data, spatial) grid, each with 4 of the 8 pairs, take
    SWIN_DATA_STEPS training steps (drop-path masks: each rank's rows of
    one global draw; the tap monitor on: each extractor's share averaged
    over the ranks); every rank must report the same losses and the same
    ``msda_tap_oob`` at every step, and keep the same parameters.  Returns
    each rank's report."""
    import tempfile

    from nmrf_tpu_torch.parallel import spawn

    out = tempfile.mkdtemp(prefix="chip_smoke_swin_data_")
    world = SWIN_DATA_GRID[0] * SWIN_DATA_GRID[1]
    spawn(swin_data_worker, world, "gloo", args=(out,), timeout_s=600)
    reports = []
    for rank in range(world):
        with open(f"{out}/swin_rank{rank}.json") as f:
            reports.append(json.load(f))
    for r in reports[1:]:
        if r["losses"] != reports[0]["losses"]:
            fail(f"swin data-parallel steps: rank {r['rank']}'s losses "
                 f"{r['losses']} differ from rank 0's {reports[0]['losses']}")
    return reports


def swin_data_worker(rank, out_dir):
    """One rank of the swin data-parallel steps (its own process)."""
    import torch
    import torch.distributed as dist

    from nmrf_tpu_torch import (build_criterion, build_model, build_optimizer,
                                make_train_step)
    from nmrf_tpu_torch.data import synthetic_batch
    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.parallel import make_mesh, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*SWIN_DATA_GRID, backend="gloo")
    cfg = main_path_cfg("bfloat16", False, True, swin=True, grid=SWIN_DATA_GRID)
    model = build_model(cfg, mesh=mesh)
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg.SOLVER.ACCUM_STEPS, grad_clip=cfg.SOLVER.GRAD_CLIP,
                           mesh=mesh, monitor_oob=True)
    H, W = cfg.DATASETS.CROP_SIZE
    batch = shard_batch(synthetic_batch(TRAIN_BATCH, H, W,
                                        max_disp=cfg.SOLVER.MAX_DISP, seed=0,
                                        disp_quantum=8), mesh)
    dist.barrier()
    _native.reset_launch_counts()
    t0 = time.perf_counter()
    history = [step(batch) for _ in range(SWIN_DATA_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, variants = _native.launch_counts(), _native.variant_counts()
    S = SWIN_DATA_STEPS
    _expect_launches(counts, f"rank {rank}, {S} swin data-parallel steps",
                     window_attention=10 * S, stripe_attention=10 * S,
                     window_attention_bwd=10 * S, stripe_attention_bwd=10 * S,
                     msda_taps=4 * S, msda_taps_bwd=4 * S)
    if variants["msda_taps_bwd"] != {"vector_masks": 4 * S}:
        fail(f"rank {rank}: B5b variants {variants['msda_taps_bwd']}")
    rows = [{k: float(v) for k, v in h.items()} for h in history]
    if not all(np.isfinite(v) for row in rows for v in row.values()) or \
            any("msda_tap_oob" not in row for row in rows):
        fail(f"rank {rank}, swin data-parallel steps: {rows}")
    checksum = torch.stack([p.detach().double().sum() for p in model.parameters()])
    sums = mesh.world.all_gather(checksum, "check")
    if not all(torch.equal(sums[0], s) for s in sums[1:]):
        fail("swin data-parallel steps: the ranks' parameters diverged")
    report = {"rank": rank, "grid": list(SWIN_DATA_GRID), "pairs_per_rank":
              TRAIN_BATCH // SWIN_DATA_GRID[0], "crop": [H, W], "steps": S,
              "seconds": seconds, "launches": counts, "variants": variants,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "losses": [{k: r[k] for k in ("total", "epe_train", "grad_norm",
                                            "msda_tap_oob")} for r in rows]}
    if rank == 0:
        log("phase 7 swin data-parallel (rank 0): " + json.dumps(report))
    with open(f"{out_dir}/swin_rank{rank}.json", "w") as f:
        json.dump(report, f)


SCALING_ITERS = 3
SCALING_KEYS = ["mesh", "variant", "devices", "ms_per_step", "global_batch",
                "weak_scaling_efficiency", "collectives_per_step",
                "comm_contract"]                          # bench_scaling.py:273-282


def scaling_phase():
    """Phase 7c: ``python -m nmrf_tpu_torch.bench_scaling --ranks 2`` on the
    card (the (1, 1), (2, 1) and (1, 2) points; ranks sharing a card over
    gloo, with a card each over NCCL; ``--out`` to a temporary file): exit
    0 (the bench holds every point to the port's communication contract),
    three rows with the JAX script's keys, the record on the GPU platform,
    efficiency null where ranks share the card."""
    import shutil
    import tempfile

    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_scaling_")
    out = os.path.join(work, "SCALING_H100.json")
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nmrf_tpu_torch.bench_scaling", "--ranks",
             "2", "--iters", str(SCALING_ITERS), "--out", out],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"bench_scaling exited {proc.returncode}: {proc.stderr[-3000:]}")
        rows = [json.loads(line) for line in proc.stdout.splitlines()
                if line.startswith("{")]
        with open(out) as f:
            record = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if [r["mesh"] for r in rows] != ["data=1x spatial=1", "data=2x spatial=1",
                                     "data=1x spatial=2"] \
            or rows != record["sweep"] or record["platform"] != "gpu":
        fail(f"bench_scaling: rows {rows}, record {record}")
    shared = torch.cuda.device_count() < 2
    for row in rows:
        if list(row)[:len(SCALING_KEYS)] != SCALING_KEYS:
            fail(f"bench_scaling: row keys {list(row)}")
        if shared and row["weak_scaling_efficiency"] is not None:
            fail(f"bench_scaling: efficiency {row['weak_scaling_efficiency']} "
                 "with ranks sharing the card")
    return {"seconds": seconds, "card": record["card"],
            "rows": [{k: r[k] for k in ("mesh", "ms_per_step", "backend",
                                        "weak_scaling_efficiency",
                                        "comm_contract")} for r in rows]}


# --------------------------------------------------------------------------- #
# --compare-old DIR: the redesigned kernels against given sources of the
# versions they replace, in turns in one process on one card
# --------------------------------------------------------------------------- #

REDESIGNED = ("window_attention", "msda_taps", "msda_taps_bwd")
COMPARE_STEPS = 5
# the C entries of the versions REDESIGNED replaced take fewer arguments:
# the new call's arguments -> the old call's (K1 and B5 before they
# reported their variant; B5b before its scratch and its variant; B5 and
# B5b before their row offsets, the three ints after the radius)
OLD_ARGS = {
    "window_attention": lambda a: a[:-1],
    "msda_taps": lambda a: a[:15] + a[18:-1],
    "msda_taps_bwd": lambda a: a[:9] + a[11:21] + a[24:-1],
}


def old_libraries(src_dir):
    """Build the sources of the REDESIGNED kernels that ``src_dir`` holds
    (with that directory's headers) with the port's nvcc flags, load them,
    and return {name: entry point}, each taking the current entry's
    arguments (``OLD_ARGS``)."""
    import ctypes

    from nmrf_tpu_torch.ops import _native

    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in REDESIGNED:
        if not os.path.exists(os.path.join(src_dir, f"{name}.cu")):
            continue
        target = _native.BUILD_DIR / f"libold_{name}.so"
        procs[name] = (subprocess.Popen(
            _native._command(name, target, src_dir), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), target)
    if not procs:
        fail(f"{src_dir} holds none of {REDESIGNED}")
    fns = {}
    for name, (proc, target) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"{src_dir}/{name}.cu did not build:\n{text}")
        log(f"  {src_dir}/{name}.cu: " + " | ".join(
            f"{fn} {regs} regs, {spills} B spilled"
            for fn, regs, spills in ptxas_kernels(text)))
        symbol, argtypes = _native._SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(target)), symbol)
        fn.argtypes = OLD_ARGS[name](argtypes)
        fn.restype = ctypes.c_int
        fns[name] = (lambda fn, cut: lambda *a: fn(*cut(a)))(fn, OLD_ARGS[name])
    return fns


# (kernel, unit, batch, cases): K1 per KITTI frame (batch 1) and per
# training step (batch TRAIN_BATCH), B5 per swin KITTI frame (batch 2, the
# left and right images), B5b per swin training step (batch 2 x
# TRAIN_BATCH); each case's last field is its launches per unit (B5b's its
# third)
COMPARE_CASES = [
    ("window_attention", "frame", 1, WINDOW_CASES),
    ("window_attention", "step", TRAIN_BATCH, TRAIN_WINDOW_CASES),
    ("msda_taps", "frame", 2, [c for c in MSDA_CASES if c[2]]),
    ("msda_taps_bwd", "swin step", 2 * TRAIN_BATCH, [c for c in MSDA_BWD_CASES if c[2]]),
]


@contextlib.contextmanager
def uncounted_variants():
    """An old library reports no variant: while its turn runs, the
    wrappers count no variant."""
    from nmrf_tpu_torch.ops import _native

    count = _native._count_variant
    _native._count_variant = lambda name, variants, code: None
    try:
        yield
    finally:
        _native._count_variant = count


def compare_phase(src_dir, gen):
    """Time the old and new versions of each REDESIGNED kernel that
    ``src_dir`` holds in turns (old, new, new, old): K1 at the KITTI
    windows (batch 1) and the training windows (batch TRAIN_BATCH) beside
    one SDPA with an additive [G, h, T, T] mask, B5 at the four extractor
    shapes of a swin KITTI request beside ``F.grid_sample``, B5b at the
    four extractor shapes of a swin training step beside ``grid_sample``'s
    backward, each with its bound; then the training steps whose path runs
    them (COMPARE_STEPS steps per turn): the default and the
    NMRF_FUSED_POS=1 step for K1, the swin step for B5 and B5b.  The
    wrappers stay the same: only the library each one launches is
    swapped."""
    import torch
    import torch.nn.functional as F

    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.ops import attention as A
    from nmrf_tpu_torch.ops import msda

    old = old_libraries(src_dir)
    new = {name: _native.library(name) for name in old}
    turns = (("old", old), ("new", new), ("new", new), ("old", old))
    dev = "cuda"
    entries = []

    def run_turns(fn):
        ms = {"old": [], "new": []}
        for tag, libs in turns:
            _native._loaded.update(libs)
            with uncounted_variants() if tag == "old" else contextlib.nullcontext():
                ms[tag].append(fn())
        _native._loaded.update(new)
        return ms

    def timed(entry, fn, iters):
        ms = run_turns(lambda: cuda_ms(fn, iters))
        entry.update(old_ms=ms["old"], new_ms=ms["new"])
        entries.append(entry)
        log("phase 8 old vs new: " + json.dumps(entry))

    with torch.inference_mode():
        C, heads = 128, 4
        for name, unit, B, cases in COMPARE_CASES[:2]:
            if name not in old:
                continue
            for label, Hp, Wp, N, ws, shift, cand, count in cases:
                qkv = torch.randn(B, Hp, Wp, N, 3 * C, generator=gen, device=dev,
                                  dtype=torch.bfloat16)
                table = 0.5 * torch.randn((2 * ws - 1) ** 2, 3 * C, generator=gen,
                                          device=dev)
                T, G = ws * ws * N, B * (Hp // ws) * (Wp // ws)
                qs, ks, vs = (torch.randn(G, heads, T, C // heads, generator=gen,
                                          device=dev, dtype=torch.bfloat16)
                              for _ in range(3))
                bias = torch.randn(G, heads, T, T, generator=gen, device=dev,
                                   dtype=torch.bfloat16)
                entry = {"name": name, "shape": label, "unit": unit,
                         "count": count, "library_ms": cuda_ms(
                             lambda: F.scaled_dot_product_attention(
                                 qs, ks, vs, attn_mask=bias), 20)}
                del qs, ks, vs, bias
                entry["bytes_ms"], entry["ops_ms"] = window_bound(
                    B, Hp, Wp, N, ws, C, heads)
                timed(entry, lambda: A.window_attention(
                    qkv, table, shift, (ws, ws), heads, cand), 20)

        M, P, D, r = MSDA_HEADS, MSDA_POINTS, MSDA_HEAD_DIM, MSDA_R
        Hq, Wq = MSDA_Q
        name, unit, B, cases = COMPARE_CASES[2]
        for label, f, count, spread in cases if name in old else ():
            Hl, Wl = Hq // f, Wq // f
            v32 = torch.randn(B, Hl, Wl, M * D, generator=gen, device=dev)
            v = v32.to(torch.bfloat16)
            dx, dy = ((torch.rand(B, Hq, Wq, M * P, generator=gen, device=dev)
                       * 2 - 1) * spread for _ in range(2))
            aw = torch.softmax(torch.randn(B, Hq, Wq, M, P, generator=gen,
                                           device=dev), -1).reshape(B, Hq, Wq, M * P)
            base_y = torch.as_tensor(msda.base_plus_one(Hq, f) - 1, device=dev)
            base_x = torch.as_tensor(msda.base_plus_one(Wq, f) - 1, device=dev)
            gx = (base_x[None, None, :, None] + dx + 0.5) / Wl * 2 - 1
            gy = (base_y[None, :, None, None] + dy + 0.5) / Hl * 2 - 1
            grid = torch.stack([gx, gy], -1).reshape(B, Hq * Wq, M, P, 2)
            grid = grid.permute(0, 2, 1, 3, 4).reshape(B * M, Hq * Wq, P, 2)
            vh = v32.reshape(B, Hl, Wl, M, D).permute(0, 3, 4, 1, 2)
            vh = vh.reshape(B * M, D, Hl, Wl)
            w = aw.reshape(B, Hq * Wq, M, P).permute(0, 2, 1, 3)
            w = w.reshape(B * M, 1, Hq * Wq, P)
            entry = {"name": name, "shape": label, "unit": unit, "count": count,
                     "library_ms": cuda_ms(lambda: (F.grid_sample(
                         vh, grid, align_corners=False) * w).sum(-1), 20)}
            entry["bytes_ms"], entry["ops_ms"] = msda_bound(B, Hq, Wq, f, M, P, D, 2)
            timed(entry, lambda: msda.msda_taps(v, dx, dy, aw, M, r), 50)

    name, unit, B, cases = COMPARE_CASES[3]
    Hq, Wq = MSDA_TRAIN_Q
    for label, f, count, spread in cases if name in old else ():
        v32, dx, dy, aw, g32 = msda_bwd_inputs(gen, B, f, spread)
        args = (v32.to(torch.bfloat16), dx, dy, aw, g32.to(torch.bfloat16), M, r)
        entry = {"name": name, "shape": label, "unit": unit, "count": count,
                 "library_ms": msda_bwd_library_ms(gen, v32, dx, dy, aw, f)}
        entry["bytes_ms"], entry["ops_ms"] = msda_bwd_bound(
            B, Hq, Wq, f, M, P, D, 2, kept_corners(dx, dy, r))
        timed(entry, lambda: msda.msda_taps_bwd(*args), 20)
        del v32, dx, dy, aw, g32, args

    steps = {}
    paths = []
    if "window_attention" in old:
        paths += [("default", False, False), ("NMRF_FUSED_POS=1", True, False)]
    if "msda_taps" in old or "msda_taps_bwd" in old:
        paths.append(("swin", False, True))
    for key, flagged, swin in paths:
        _, step, batch = train_setup(swin)
        step(batch)  # warm-up
        if swin and "msda_taps_bwd" in old:  # B5b on the step's own inputs
            for args in captured_msda_bwd_inputs(step, batch):
                f = args[1].shape[1] // args[0].shape[1]
                entry = {"name": "msda_taps_bwd", "shape": f"train step extractor/f{f}",
                         "unit": "swin step, its inputs", "count": 1,
                         "library_ms": msda_bwd_library_ms(
                             gen, args[0].float(), *args[1:4], f)}
                entry["bytes_ms"], entry["ops_ms"] = msda_bwd_bound(
                    *args[1].shape[:3], f, MSDA_HEADS, MSDA_POINTS, MSDA_HEAD_DIM,
                    2, kept_corners(args[1], args[2], MSDA_R))
                timed(entry, lambda: msda.msda_taps_bwd(*args), 20)

        def timed_steps():
            step(batch)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(COMPARE_STEPS):
                step(batch)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / COMPARE_STEPS

        with fused_pos() if flagged else contextlib.nullcontext():
            steps[key] = run_turns(timed_steps)
        log(f"phase 8 old vs new, {key} step: " + json.dumps(steps[key]))
        del step, batch
        torch.cuda.empty_cache()
    totals = {}
    units = [(name, unit) for name, unit, _, _ in COMPARE_CASES]
    units.append(("msda_taps_bwd", "swin step, its inputs"))
    for name, unit in units:
        rows = [e for e in entries if e["name"] == name and e["unit"] == unit]
        if not rows:
            continue
        key = f"{name} per {unit}"
        totals[key] = {k: sum(float(np.mean(e[k])) * e["count"] for e in rows)
                       for k in ("old_ms", "new_ms", "library_ms")}
        totals[key]["bound_ms"] = sum(
            max(e["bytes_ms"], e["ops_ms"]) * e["count"] for e in rows)
    slower = [f"{e['name']} {e['shape']}" for e in entries
              if max(e["new_ms"]) >= min(e["old_ms"])]

    return {"per_unit": totals, "step_ms": steps, "steps_per_turn": COMPARE_STEPS,
            "new_not_faster_on": slower, "shapes": entries}


# --------------------------------------------------------------------------- #
# --k1-stages: K1's tensor-core kernel with one stage cut out at a time
# (outputs wrong, only timed): the cut's time saved is that stage's share
# --------------------------------------------------------------------------- #

K1_CUTS = {
    # the positional blocks qr and kr (stage 2)
    "positional": ("    // ---- 2. positional blocks: Q and K against every table row ----",
                   "    __syncthreads();  // kr[j, .] is read by the warps of the query rows",
                   None),
    # the logits' positional loads, region loads and masks (stage 3)
    "logit_terms": ("""            float x = s[c][e] * p.scale + sqr[ri[r] * P + pj] + skr[(base + j) * P + pr[r]];
            if ((p.candidate_mask && pj == pr[r] && j != ti[r]) ||
                (p.shift > 0 && reg_i[r] != sreg[base + j]))
              x += kNegInf;""", None,
                    "            float x = s[c][e] * p.scale + (0 * (j + pj + r));"),
    # the mass rescale to the final max (end of stage 3)
    "mass_rescale": ("        sqr[row * P + s] *= __expf(smx[row * MT + ((s << nshift) >> 4)] - "
                     "smx[row * MT + MT - 1]);", None, "        (void)row; (void)s;"),
    # the value-table product Wm VE (stage 4)
    "value_table": ("      for (int tp = 0; tp < TR / 16; ++tp) {\n        float w[2][4];", None,
                    "      for (int tp = 0; tp < 0; ++tp) {\n        float w[2][4];"),
}
K1_STAGE_CASES = [c[:1] + (1,) + c[1:7] for c in WINDOW_CASES[1::2]] \
    + [c[:1] + (TRAIN_BATCH,) + c[1:7] for c in TRAIN_WINDOW_CASES[1::2]]


def k1_stage_phase(gen):
    """Build window_attention.cu with each of K1_CUTS cut out (besides the
    whole kernel), and time each at a KITTI and a training window of
    Inference and Refinement (bf16, shifted), in two passes: us per
    launch."""
    import ctypes
    import shutil

    import torch

    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.ops import attention as A

    src = (_native.CSRC / "window_attention.cu").read_text()
    variants = {"whole": src}
    for name, (start, end, repl) in K1_CUTS.items():
        if start not in src or (end and end not in src):
            fail(f"--k1-stages: the {name} stage's text is not in window_attention.cu")
        variants[name] = (src[:src.index(start)] + src[src.index(end):] if end
                          else src.replace(start, repl))
    root = _native.BUILD_DIR / "k1_stages"
    procs = {}
    for name, text in variants.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for h in _native.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "window_attention.cu").write_text(text)
        procs[name] = (subprocess.Popen(
            _native._command("window_attention", root / f"lib_{name}.so", d),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            root / f"lib_{name}.so")
    fns = {}
    for name, (proc, target) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"--k1-stages: {name} did not build:\n{text}")
        symbol, argtypes = _native._SIGNATURES["window_attention"]
        fn = getattr(ctypes.CDLL(str(target)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    new = _native.library("window_attention")
    out = {}
    with torch.inference_mode():
        for label, B, Hp, Wp, N, ws, shift, cand in K1_STAGE_CASES:
            qkv = torch.randn(B, Hp, Wp, N, 384, generator=gen, device="cuda",
                              dtype=torch.bfloat16)
            table = 0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=gen,
                                      device="cuda")
            us = {name: [] for name in fns}
            for _ in range(2):
                for name, fn in fns.items():
                    _native._loaded["window_attention"] = fn
                    us[name].append(1e3 * cuda_ms(lambda: A.window_attention(
                        qkv, table, shift, (ws, ws), 4, cand), 30))
            _native._loaded["window_attention"] = new
            whole = float(np.mean(us["whole"]))
            out[f"{label} batch {B}"] = {
                "whole_us": us["whole"],
                "saved_us": {n: whole - float(np.mean(v)) for n, v in us.items()
                             if n != "whole"}}
            log(f"K1 stages {label} batch {B}: " + json.dumps(out[f"{label} batch {B}"]))
    return out


# the serving entry points (phase 9): the exported artifact, the HTTP
# server and the demo and KITTI-submission CLI

SERVE_NODES = ("window_attention", "stripe_attention", "msda_taps")


def _kitti_pairs(n, seed):
    """n KITTI-size pairs of uint8-valued float32 images (seeded)."""
    rng = np.random.RandomState(seed)
    return [tuple(rng.randint(0, 256, (H_KITTI, W_KITTI, 3)).astype(np.float32)
                  for _ in range(2)) for _ in range(n)]


def _final_logits(model, img1, img2):
    """The last Inference layer's selection logits [B, H, W, N] of an eval
    forward on padded device images, read with a hook on the score head."""
    import torch

    seen = []
    handle = model.infer_score_head.register_forward_hook(
        lambda m, args, out: seen.append(0.25 * out[-1].float()))
    try:
        with torch.inference_mode():
            model(img1, img2)
    finally:
        handle.remove()
    B, h, w, N, _ = seen[0].shape
    return seen[0].reshape(B, h, w, N, 8, 8).permute(0, 1, 4, 2, 5, 3) \
        .reshape(B, 8 * h, 8 * w, N)


def _compare_served(model, pair, got, divis_by):
    """Max |delta| of a served disparity against the live predict; when not
    bit for bit, fail on a difference above 1e-3 px outside the refinement's
    reach (96 px) of an argmax near-tie (top-2 logit margin below 1e-2,
    about two bf16 roundings of a logit near 1)."""
    import torch
    import torch.nn.functional as F

    from nmrf_tpu_torch import predict
    from nmrf_tpu_torch.data.frame_io import InputPadder

    want = predict(model, *pair)
    err = float(np.abs(got - want).max())
    if err == 0.0:
        return err
    padder = InputPadder(pair[0].shape, mode="proposal", divis_by=divis_by)
    a, b = (torch.from_numpy(x[None]).cuda() for x in padder.pad(*pair))
    top2 = torch.topk(_final_logits(model, a, b), 2, dim=-1).values
    near_tie = (top2[..., 0] - top2[..., 1] < 1e-2).float()
    tie = (F.max_pool2d(near_tie[:, None], 193, 1, 96)[0, 0] > 0).cpu().numpy()
    tie = tie[:H_KITTI, :W_KITTI]
    bad = np.abs(got - want) > 1e-3
    log(f"phase 9: served disparity differs from predict by up to {err:.3e} "
        f"px on {int(bad.sum())} pixels, {int(bad[~tie].sum())} outside "
        f"argmax near-tie regions")
    if bad[~tie].any():
        fail(f"served disparity differs from predict by {err} px outside "
             "argmax near-tie regions")
    return err


def _post(url, img1, img2):
    import io
    import urllib.request

    buf = io.BytesIO()
    np.savez(buf, img1=img1, img2=img2)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        body, timing = r.read(), json.loads(r.headers["X-Timing-Ms"])
    wall = (time.perf_counter() - t0) * 1e3
    return np.load(io.BytesIO(body)), wall, timing


def _write_kitti_testing(root, pairs):
    from PIL import Image

    base = os.path.join(root, "KITTI", "KITTI_2015", "testing")
    for i, pair in enumerate(pairs):
        for side, img in zip(("image_2", "image_3"), pair):
            os.makedirs(os.path.join(base, side), exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(base, side, f"{i:06d}_10.png"))
    return base


def serving_entry_phase(swin=False):
    """Phase 9 for one model (module docstring): export, save and load the
    frozen artifact, serve 4 KITTI pairs over HTTP, write a KITTI
    submission and render the demo through the CLI."""
    import shutil
    import tempfile
    import threading
    from http.server import HTTPServer

    import torch

    from nmrf_tpu_torch import build_model, inference, predict
    from nmrf_tpu_torch.data.frame_io import read_disp_kitti
    from nmrf_tpu_torch.ops import _native
    from nmrf_tpu_torch.tools import export_serving, serve_http
    from nmrf_tpu_torch.utils.export import load_exported, load_meta

    name = "swin" if swin else "resnet"
    cfg = main_path_cfg("bfloat16", True, True, swin)
    model = build_model(cfg)
    tmp = tempfile.mkdtemp(prefix="nmrf_serve_")
    report = {"model": name}
    try:
        path = os.path.join(tmp, f"kitti_{name}.pt2")
        _, shape, size, export_s = export_serving.export_artifact(
            model, cfg, H_KITTI, W_KITTI, path)
        t0 = time.perf_counter()
        exported = load_exported(path)
        load_s = time.perf_counter() - t0
        meta = load_meta(path)
        if meta["device"] != "cuda:0" or meta["input_shape"] != list(shape):
            fail(f"{name} artifact: sidecar {meta}")
        targets = [str(n.target) for n in exported.graph.nodes
                   if n.op == "call_function"]
        nodes = {k: sum(t == f"nmrf.{k}.default" for t in targets)
                 for k in SERVE_NODES}
        want_nodes = {"window_attention": 10, "stripe_attention": 10,
                      "msda_taps": 4 if swin else 0}
        if nodes != want_nodes:
            fail(f"{name} artifact: graph nodes {nodes}, expected {want_nodes}")
        checks = sum(t == "aten._assert_tensor_metadata.default"
                     for t in targets)
        report.update(shape=list(shape), export_s=export_s, load_s=load_s,
                      size_mb=size / 1e6, graph_nodes=len(targets),
                      metadata_check_nodes=checks, op_nodes=nodes)
        log(f"phase 9 {name} artifact: exported at {list(shape)} in "
            f"{export_s:.1f} s, loaded in {load_s:.1f} s, {size / 1e6:.1f} MB; "
            f"op nodes {json.dumps(nodes)} of {len(targets)}, {checks} of "
            f"them metadata checks ({gpu_identity()})")

        # the server, in a thread of this process
        srv = HTTPServer(("127.0.0.1", 0),
                         serve_http.make_handler(exported, meta))
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        pairs = _kitti_pairs(REQUESTS + 1, seed=9)
        try:
            url = f"http://127.0.0.1:{srv.server_port}/disparity"
            _post(url, *pairs[0])  # warm-up: cuDNN plans, first launches
            _native.reset_launch_counts()
            served, walls, splits = [], [], []
            for pair in pairs[1:]:
                disp, wall, timing = _post(url, *pair)
                served.append(disp)
                walls.append(wall)
                splits.append(timing)
            counts = _native.launch_counts()
        finally:
            srv.shutdown()
            srv.server_close()
        _expect_launches(counts, f"{name}: {REQUESTS} served requests",
                         window_attention=10 * REQUESTS,
                         stripe_attention=10 * REQUESTS,
                         msda_taps=(4 if swin else 0) * REQUESTS)
        errs = []
        for pair, disp in zip(pairs[1:], served):
            if disp.shape != (H_KITTI, W_KITTI) or disp.dtype != np.float32:
                fail(f"{name}: served disparity {disp.shape} {disp.dtype}")
            if not np.isfinite(disp).all() or (disp < 0).any():
                fail(f"{name}: served disparity not finite and non-negative")
            errs.append(_compare_served(model, pair, disp, cfg.DATASETS.DIVIS_BY))

        # device time of the artifact's call, and a profiled call
        module = exported.module()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        device_ms = []
        for pair in pairs[1:]:
            a, b = (torch.from_numpy(np.pad(
                x, ((0, shape[1] - H_KITTI), (0, shape[2] - W_KITTI), (0, 0)),
                mode="edge")[None]).cuda() for x in pair)
            with torch.no_grad():
                start.record()
                module(a, b)
                end.record()
            torch.cuda.synchronize()
            device_ms.append(start.elapsed_time(end))
        with torch.no_grad():
            profile = profile_phase(f"{name} artifact request",
                                    lambda: module(a, b))
        report.update(
            requests=REQUESTS, launches={k: counts[k] for k in SERVE_NODES},
            max_abs_err_vs_predict=max(errs), client_wall_ms=walls,
            x_timing_ms=splits, device_ms=device_ms,
            request_profile={k: profile[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share")})
        log(f"phase 9 {name} server: {REQUESTS} requests, client wall ms "
            f"{json.dumps([round(w, 3) for w in walls])}, device ms "
            f"{json.dumps([round(d, 3) for d in device_ms])}, max |delta| vs "
            f"predict {max(errs)}, launches {json.dumps(report['launches'])} "
            f"({gpu_identity()}); X-Timing-Ms {json.dumps(splits)}")

        # the KITTI submission through the CLI, on 2 of the pairs
        root = os.path.join(tmp, "data")
        base = _write_kitti_testing(root, pairs[1:3])
        out = os.path.join(tmp, "submission")
        config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "sceneflow_swint.yaml")
        flags = (["--config-file", config] if swin else []) + [
            "--device", "cuda"]
        opts = ["TPU.COMPUTE_DTYPE", "bfloat16", "TPU.GELU_APPROX", "True",
                "DATASETS.ROOT", root]
        _native.reset_launch_counts()
        t0 = time.perf_counter()
        written = inference.main(["--dataset-name", "kitti_2015", "--output",
                                  out] + flags + opts)
        cli_s = time.perf_counter() - t0
        counts = _native.launch_counts()
        _expect_launches(counts, f"{name}: the KITTI submission of 2 pairs",
                         window_attention=20, stripe_attention=20,
                         msda_taps=8 if swin else 0)
        if sorted(os.path.basename(p) for p in written) != \
                ["000000_10.png", "000001_10.png"]:
            fail(f"{name}: KITTI submission wrote {written}")
        # the files hold predict's disparity in the submission's encoding
        # (uint16 of 256 x disparity, which wraps above 255.996 px, as the
        # JAX package's and the reference's writers do)
        differ, top = 0, 0.0
        for i, pair in enumerate(pairs[1:3]):
            disp, _ = read_disp_kitti(os.path.join(out, f"{i:06d}_10.png"))
            want = predict(model, *pair)
            code = np.round(want * 256).astype(np.uint16)
            differ += int((disp * 256 != code).sum())
            top = max(top, float(want.max()))
        if differ:
            fail(f"{name}: {differ} KITTI submission values differ from the "
                 "encoding of predict")
        report.update(kitti_submission_s=cli_s, kitti_values_differing=differ,
                      max_disparity_px=top)
        log(f"phase 9 {name} KITTI submission: 2 files in {cli_s:.1f} s "
            f"(with the model's build), every value the uint16 encoding of "
            f"predict (largest disparity {top:.2f} px)")

        # the demo rendering of the --input glob mode
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            report["demo"] = "matplotlib not installed"
            log(f"phase 9 {name} demo rendering: not run, matplotlib is not "
                "installed on this machine (the CPU tests hold the renderer)")
        else:
            demo = os.path.join(tmp, "demo")
            written = inference.main(
                ["--input", os.path.join(base, "image_2", "*.png"),
                 os.path.join(base, "image_3", "*.png"), "--output", demo]
                + flags + opts)
            if len(written) != 2 or not all(os.path.getsize(p) for p in written):
                fail(f"{name}: demo rendering wrote {written}")
            report["demo"] = [os.path.basename(p) for p in written]
            log(f"phase 9 {name} demo rendering: {json.dumps(report['demo'])}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return report


def serving_phase():
    """Phase 9: both models through the serving entry points (the counts
    set to 0 and read around each path inside), then the host cost of the
    registered operators' dispatch."""
    import torch

    report = {"resnet": serving_entry_phase()}
    torch.cuda.empty_cache()
    report["swin"] = serving_entry_phase(swin=True)
    torch.cuda.empty_cache()
    report["op_dispatch_us"] = op_dispatch_phase()
    log("phase 9 operator dispatch, host us per call (op, launch function, "
        f"added) ({gpu_identity()}): " + json.dumps(report["op_dispatch_us"]))
    return report


def op_dispatch_phase():
    """Phase 9: host time of a call of each ``nmrf`` operator against a
    direct call of its launch function at the serving shapes (bf16), us
    per call over 200 calls each, in turns."""
    import torch

    from nmrf_tpu_torch.ops import attention as A
    from nmrf_tpu_torch.ops import msda

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    qkv = torch.randn(1, 48, 156, 4, 384, generator=g, device="cuda").to(bf)
    table = torch.randn(121, 384, generator=g, device="cuda")
    q = torch.randn(1, 47, 156, 4, 64, generator=g, device="cuda").to(bf)
    vmap = torch.randn(1, 12, 39, 64, generator=g, device="cuda").to(bf)
    dx = torch.randn(1, 96, 312, 32, generator=g, device="cuda")
    cases = {
        "window_attention": (A.window_attention_op, A._window_attention_launch,
                             (qkv, table, 3, [6, 6], 4, True, 0, None)),
        "stripe_attention": (A.stripe_attention_op, A._stripe_attention_launch,
                             (q, q, q, 47, 1, 2)),
        "msda_taps": (msda.msda_taps_op, msda._msda_taps_launch,
                      (vmap, dx, dx, dx, 8, 5)),
    }
    out = {}
    with torch.inference_mode():
        for name, (op, launch, args) in cases.items():
            times = {"op": [], "launch": []}
            for fn, key in ((op, "op"), (launch, "launch"), (launch, "launch"),
                            (op, "op")):
                fn(*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn(*args)
                times[key].append((time.perf_counter() - t0) / 200 * 1e6)
                torch.cuda.synchronize()
            out[name] = {k: sum(v) / len(v) for k, v in times.items()}
            out[name]["added_us"] = out[name]["op"] - out[name]["launch"]
    return out


# --------------------------------------------------------------------------- #
# the measurement entry points (phase 10)
# --------------------------------------------------------------------------- #

BENCH_REPEAT = 3
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]   # bench.py:142-147
TRAIN_KEYS = ["metric", "value", "unit", "frames_per_s", "total_loss",
              "tflops_per_step", "mfu"]                   # bench_train.py:104-112
SWIN_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "sceneflow_swint.yaml")


def run_entry(main, argv, what, phase="phase 10"):
    """An entry point's ``main(argv)`` in this process, its stdout captured,
    the launch counters set to 0 just before and read just after: (its
    result, its stdout lines, the launches)."""
    import io

    from nmrf_tpu_torch.ops import _native

    buf = io.StringIO()
    _native.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    counts = _native.launch_counts()
    lines = buf.getvalue().splitlines()
    log(f"{phase} {what}: {time.perf_counter() - t0:.1f} s; stdout "
        + json.dumps(lines[-8:]))
    return result, lines, counts


def json_line(lines, what, keys):
    """The one JSON line of a bench's stdout, with exactly ``keys``."""
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    if len(rows) != 1:
        fail(f"{what}: {len(rows)} JSON lines on stdout, expected 1")
    if list(rows[0]) != keys:
        fail(f"{what}: keys {list(rows[0])}, expected the JAX bench's {keys}")
    return rows[0]


def top_rows(summary, n=5):
    """The first rows of a trace summary, kernel names cut to 80 characters."""
    return [(ms, count, name[:80], group)
            for ms, count, name, group in summary[0][:n]]


def bench_phase(flops_out=None):
    """Phase 10: the measurement entry points in this process at full width
    (``python -m nmrf_tpu_torch.bench`` and the rest, through their
    ``main``), each stdout line checked; returns their records.  The FLOP
    record goes to ``flops_out`` if given, else into the phase's temporary
    directory, so a run leaves the checkout's files as they were."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    try:
        return _bench_entries(
            work, flops_out or os.path.join(work, "FLOPS_H100.json"))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _bench_entries(work, flops_out):
    """``bench_phase``'s body; the traces go under ``work``, the FLOP record
    to ``flops_out``."""
    import math

    import torch

    from nmrf_tpu_torch import bench, bench_train
    from nmrf_tpu_torch.tools import (bench_loader, bench_photometric,
                                      bench_stages, bench_swin_parts,
                                      check_tap_coverage, flops, profile_model,
                                      profile_train)

    out = {"card": gpu_identity()}
    frames = bench.K * BENCH_REPEAT
    for name, extra in (("resnet", []), ("swin", ["--config-file", SWIN_CONFIG])):
        what = f"bench {name}"
        res, lines, counts = run_entry(
            bench.main, ["--repeat", str(BENCH_REPEAT), "--profile-dir",
                         os.path.join(work, name)] + extra, what)
        rec = json_line(lines, what, BENCH_KEYS)
        metric = "kitti_1242x375_latency" + ("_sceneflow_swint" if extra else "")
        if rec["metric"] != metric or rec["unit"] != "ms/frame" or not (
                math.isfinite(rec["value"]) and rec["value"] > 0):
            fail(f"{what}: {rec}")
        _expect_launches(res["launches"], f"{what}'s timed chains",
                         window_attention=10 * frames,
                         stripe_attention=10 * frames,
                         msda_taps=(4 if extra else 0) * frames)
        if any(counts[k] < n for k, n in res["launches"].items()):
            fail(f"{what}: launches {counts} around main, fewer than its "
                 f"timed chains' {res['launches']}")
        kernel_flops = {k: v for k, v in res["flops_by_op"].items()
                        if k.startswith("nmrf.")}
        if abs(res["deployed_flops"] - res["plain_flops"]) > \
                0.01 * res["plain_flops"] or not (
                kernel_flops.get("nmrf.window_attention", 0) > 0
                and kernel_flops.get("nmrf.stripe_attention", 0) > 0):
            fail(f"{what}: deployed FLOPs {res['deployed_flops']} (kernels "
                 f"{kernel_flops}) against the plain path's "
                 f"{res['plain_flops']}")
        groups = res["profile"][3]
        if not {"window_attention (K1)", "stripe_attention (K2)"} <= set(groups):
            fail(f"{what}: the profile's groups {list(groups)} miss K1 or K2")
        out[f"bench_{name}"] = {
            "record": rec, "wall_ms": res["wall_ms"],
            "device_ms": res["device_ms"], "launches": res["launches"],
            "deployed_flops": res["deployed_flops"],
            "plain_flops": res["plain_flops"], "kernel_flops": kernel_flops,
            "bytes": res["bytes"],
            "mfu": flops.mfu(res["deployed_flops"], rec["value"]),
            "profile": {"busy_ms": res["profile"][1],
                        "idle_share": res["profile"][2],
                        "groups": {g: v for g, v in groups.items()}}}
        log(f"phase 10 {what}: " + json.dumps(out[f"bench_{name}"]))
        torch.cuda.empty_cache()

    for name, fused, extra in (("resnet", False, []), ("fused_pos", True, []),
                               ("swin", False, ["--config-file", SWIN_CONFIG])):
        what = f"bench_train {name}"
        with fused_pos() if fused else contextlib.nullcontext():
            res, lines, counts = run_entry(
                bench_train.main, extra + ["TPU.COMPUTE_DTYPE", "bfloat16"],
                what)
        rec = json_line(lines, what, TRAIN_KEYS)
        metric = "train_step_384x768_b8" + ("_sceneflow_swint" if extra else "")
        if rec["metric"] != metric or not math.isfinite(rec["total_loss"]) \
                or not 0 < rec["mfu"] < 1 or not rec["value"] > 0:
            fail(f"{what}: {rec}")
        steps = bench_train.ITERS
        window_bwd = "window_attention_pos_bwd" if fused else "window_attention_bwd"
        taps = {"msda_taps": 4 * steps, "msda_taps_bwd": 4 * steps} \
            if extra else {}
        _expect_launches(res["launches"], f"{what}'s timed steps",
                         window_attention=10 * steps,
                         stripe_attention=10 * steps,
                         stripe_attention_bwd=10 * steps,
                         **{window_bwd: 10 * steps}, **taps)
        out[f"bench_train_{name}"] = {"record": rec,
                                      "device_ms": res["device_ms"],
                                      "flops": res["flops"],
                                      "launches": res["launches"]}
        log(f"phase 10 {what}: " + json.dumps(out[f"bench_train_{name}"]))
        torch.cuda.empty_cache()

    rows, _, counts = run_entry(bench_stages.main, [], "bench_stages")
    ms = {r["stage"]: r["ms"] for r in rows}
    if not (ms["sum_of_stages"] > 0 and ms["full_forward"] > 0):
        fail(f"bench_stages: {ms}")
    out["bench_stages"] = ms
    log(f"phase 10 bench_stages: sum_of_stages {ms['sum_of_stages']} ms, "
        f"full_forward {ms['full_forward']} ms; " + json.dumps(ms))
    rows, _, counts = run_entry(bench_swin_parts.main, ["--iters", "10"],
                                "bench_swin_parts")
    out["bench_swin_parts"] = {r["part"]: r["ms"] for r in rows}
    if counts["msda_taps"] == 0:
        fail(f"bench_swin_parts launched no B5: {counts}")
    summary, _, counts = run_entry(
        profile_model.main, ["--out", os.path.join(work, "profile_model"),
                             "--top", "8"], "profile_model")
    out["profile_model"] = {"busy_ms": summary[1], "idle_share": summary[2],
                            "top": top_rows(summary)}
    res, _, counts = run_entry(
        profile_train.main, ["--out", os.path.join(work, "profile_train"),
                             "--top", "8"], "profile_train")
    out["profile_train"] = {"split_ms": res["split_ms"],
                            "wall_ms": res["wall_ms"],
                            "busy_ms": res["summary"][1],
                            "idle_share": res["summary"][2],
                            "top": top_rows(res["summary"])}
    log("phase 10 profiles: " + json.dumps(
        {k: out[k] for k in ("profile_model", "profile_train")}))
    res, _, _ = run_entry(bench_loader.main, ["--size", "32", "--workers", "4"],
                          "bench_loader")
    out["bench_loader"] = res
    res, _, _ = run_entry(bench_photometric.main, [], "bench_photometric")
    out["bench_photometric"] = res
    log("phase 10 host: " + json.dumps(
        {k: out[k] for k in ("bench_loader", "bench_photometric")}))
    rc, lines, counts = run_entry(
        check_tap_coverage.main, ["--hw", "375x1242", "--config-file",
                                  SWIN_CONFIG], "check_tap_coverage")
    if rc != 0 or counts["msda_taps"] != 4:
        fail(f"check_tap_coverage: exit {rc}, launches {counts}: {lines}")
    out["check_tap_coverage"] = lines[-1]

    record, _, _ = run_entry(flops.main, [
        "--infer-ms", str(out["bench_resnet"]["record"]["value"]),
        "--swin-ms", str(out["bench_swin"]["record"]["value"]),
        "--train-ms", str(out["bench_train_resnet"]["record"]["value"]),
        "--fused-train-ms", str(out["bench_train_fused_pos"]["record"]["value"]),
        "--swin-train-ms", str(out["bench_train_swin"]["record"]["value"]),
        "--train-batch", "8", "--out", flops_out], "flops")
    mfus = [record[k]["mfu"] for k in ("inference_resnet", "inference_swin")]
    mfus += [record["train_step_resnet"][v]["mfu"]
             for v in ("default", "fused_pos")]
    mfus.append(record["train_step_swin"]["default"]["mfu"])
    if not all(0 < m < 1 for m in mfus):
        fail(f"FLOPS_H100.json: MFU outside (0, 1): {mfus}")
    out["flops"] = record
    return out


def kernel_flop_shares(kernel_results, bench):
    """Each kernel's bound operation count per unit of the kernels line and
    per launch, and its share of the frame's (K1, K2: resnet; B5: swin) or
    step's FLOPs (phase 10's plain-path counts).  These are not measured:
    each is the bound's ``ops_ms`` times the peak it was divided by (the
    counted FLOPs of K1 and K2; the backwards' recomputes, which the plain
    path's count does not have; B5's and B5b's f32 work, which the FLOP
    count, elementwise, leaves out)."""
    denom = {"window_attention": bench["bench_resnet"]["deployed_flops"],
             "stripe_attention": bench["bench_resnet"]["deployed_flops"],
             "msda_taps": bench["bench_swin"]["deployed_flops"],
             "window_attention_bwd": bench["bench_train_resnet"]["flops"],
             "stripe_attention_bwd": bench["bench_train_resnet"]["flops"],
             "window_attention_pos_bwd": bench["bench_train_fused_pos"]["flops"],
             "msda_taps_bwd": bench["bench_train_swin"]["flops"]}
    out = {}
    for name, entries in kernel_results.items():
        timed = [e for e in entries if e["count"]]
        if name not in denom or not timed:
            continue
        ops = sum(e["ops_ms"] * e["count"] for e in timed) / 1e3 * (
            F32_OPS_PER_S if name.startswith("msda") else BF16_OPS_PER_S)
        out[name] = {"bound_ops_per_unit": ops,
                     "bound_ops_per_launch": ops / sum(e["count"] for e in timed),
                     "share_of_flops": ops / denom[name]}
    return out


def kernels_line(kernel_results, counts):
    """The kernels JSON line.  Times are per unit of each kernel's main
    path: per KITTI frame for K1/K2/B5 (serving) and B6 (sharded serving,
    one rank), per training step for K1b/K2b, B7 (NMRF_FUSED_POS=1) and
    B6b (sharded, one rank).  K1 also carries its time, plain time, SDPA
    time and bound per training step (its 10 launches at batch
    TRAIN_BATCH, from the entries of unit "step")."""
    units = {
        "window_attention": "per frame: the 10 launches of one KITTI request, bf16",
        "stripe_attention": "per frame: the 10 launches of one KITTI request, bf16",
        "window_attention_bwd": f"per training step: 10 launches at batch {TRAIN_BATCH}, 384x768, bf16",
        "stripe_attention_bwd": f"per training step: 10 launches at batch {TRAIN_BATCH}, 384x768, bf16",
        "msda_taps": "per frame: the 4 launches of one swin KITTI request, "
                     "bf16; on_a_rank_tile: one rank's 4 launches of a 1 x 2 "
                     f"sharded swin step at batch {2 * TRAIN_BATCH} (query "
                     "rows 48 of 96 from row 48, the level maps with their "
                     "halo rows), bf16",
        "masked_attention": "per frame: the 5 launches of one rank of a 1 x 2 "
                            "sharded KITTI request (384x1248), bf16; launches: "
                            "rank 0's over the 4 requests",
        "masked_attention_bwd": f"per training step: the 5 launches of one rank "
                                f"of a 1 x 2 sharded step at batch {TRAIN_BATCH}, "
                                f"384x768, bf16; launches: rank 0's over the "
                                f"{SHARD_TRAIN_STEPS} timed steps",
        "window_attention_pos_bwd": f"per NMRF_FUSED_POS=1 training step: 10 "
                                    f"launches at batch {TRAIN_BATCH}, 384x768, "
                                    f"bf16",
        "msda_taps_bwd": f"per swin training step: the 4 launches at batch "
                         f"{2 * TRAIN_BATCH} (the left and right images of "
                         f"{TRAIN_BATCH} pairs, query grid 96x192), bf16, "
                         f"displacements uniform within +-{MSDA_R - 0.5} level "
                         f"pixels; on_training_step_inputs: on the samples of "
                         f"one step of the main path; on_a_rank_tile: one "
                         f"rank's 4 launches of a 1 x 2 sharded swin step "
                         f"(query rows 48 of 96 from row 48, the level maps "
                         f"with their halo rows)",
    }
    line = []
    for name, entries in kernel_results.items():
        timed = [e for e in entries if e["count"]]
        agg = {k: sum(e[k] * e["count"] for e in timed)
               for k in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
        # K1 in the training step beside its per-frame unit, and B5b on a
        # training step's samples beside its uniform ones
        extra = {}
        for unit, field in (("step", "per_training_step"),
                            ("step_inputs", "on_training_step_inputs"),
                            ("tile", "on_a_rank_tile")):
            sel = [e for e in entries if e.get("unit") == unit]
            if not sel:
                continue
            extra[field] = {k: sum(e[k] * e["step_count"] for e in sel)
                            for k in ("ms", "plain_ms", "library_ms")}
            extra[field]["bound_ms"] = sum(
                max(e["bytes_ms"], e["ops_ms"]) * e["step_count"] for e in sel)
            if "split_ms" in sel[0]:
                extra[field]["parts_ms"] = {
                    k: sum(e["split_ms"][k] * e["step_count"] for e in sel)
                    for k in sel[0]["split_ms"]}
        line.append({
            "name": name, "route": "cuda",
            "source": f"nmrf_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": counts[name],
            "max_abs_err": max(e.get(k, 0.0) for e in entries for k in (
                "max_abs_err_bfloat16", "max_abs_err_bfloat16_batch8")),
            "max_abs_err_f32": max(e.get("max_abs_err_float32", 0.0) for e in entries),
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": sum(max(e["bytes_ms"], e["ops_ms"]) * e["count"]
                            for e in timed),
            "bound_by": "bytes" if agg["bytes_ms"] >= agg["ops_ms"] else "operations",
            "library_ms": agg["library_ms"],
            "unit": units[name],
            **extra,
            **({"parts_ms": {k: sum(e["split_ms"][k] * e["count"] for e in timed)
                             for k in timed[0]["split_ms"]}}
               if timed and "split_ms" in timed[0] else {}),
            "shapes": entries,
        })
    return {"kernels": line}


def main(argv=None):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sharded-only", action="store_true",
                        help="build the kernels and run phase 7 alone")
    parser.add_argument("--grid", type=int, nargs=2, default=SHARD_GRID,
                        metavar=("DATA", "SPATIAL"),
                        help="phase 7's process grid (default 1 2)")
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                        help="phase 7's backend: gloo (ranks may share a "
                             "card) or nccl (a card per rank)")
    parser.add_argument("--compare-old", metavar="DIR",
                        help="build the kernels and time K1, B5 and B5b "
                             "against DIR's window_attention.cu, msda_taps.cu "
                             "and msda_taps_bwd.cu, those it holds (with "
                             "DIR's headers), in turns")
    parser.add_argument("--k1-stages", action="store_true",
                        help="build the kernels and time K1's tensor-core "
                             "kernel with each stage cut out in turn")
    parser.add_argument("--entry-only", action="store_true",
                        help="build the kernels and run phase 8 alone")
    parser.add_argument("--serve-only", action="store_true",
                        help="build the kernels and run phase 9 alone")
    parser.add_argument("--bench-only", action="store_true",
                        help="build the kernels and run phase 10 alone")
    parser.add_argument("--flops-out", metavar="PATH",
                        help="keep phase 10's FLOPS_H100.json record at PATH "
                             "(default: written to the phase's temporary "
                             "directory and removed with it)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from nmrf_tpu_torch import predict
    from nmrf_tpu_torch.ops import _native

    os.environ.pop("NMRF_FUSED_POS", None)  # flagged runs set it themselves
    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    report = _native.build_all()
    log(f"phase 1 build: {time.perf_counter() - t_start:.1f} s for "
        f"{len(report)} kernels (nvcc in parallel)")
    for name, (secs, text) in report.items():
        log(f"  {name}: {secs:.1f} s; " + " | ".join(
            f"{fn} {regs} regs, {spills} B spilled"
            for fn, regs, spills in ptxas_kernels(text)))
    check_spills(report)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.k1_stages:
        stages = k1_stage_phase(torch.Generator(device="cuda").manual_seed(0))
        log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
        log(gpu_identity())
        log(json.dumps({"k1_stages": stages}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.compare_old:
        compare = compare_phase(args.compare_old,
                                torch.Generator(device="cuda").manual_seed(0))
        log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
        log(gpu_identity())
        log(json.dumps({"compare": {k: v for k, v in compare.items()
                                    if k != "shapes"}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.entry_only:
        entry = entry_point_phase()
        diagnostics = diagnostics_phase()
        log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
        log(gpu_identity())
        log(json.dumps({"entry_point": entry, "diagnostics": diagnostics}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.serve_only:
        serving = serving_phase()
        log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
        log(gpu_identity())
        log(json.dumps({"serving": serving}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.bench_only:
        benches = bench_phase(args.flops_out)
        log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
        log(gpu_identity())
        log(json.dumps({"bench": benches}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.sharded_only:
        sharded = sharded_phase(args.grid, args.backend)
        log_sharded_swin(sharded)
        log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
        log(gpu_identity())
        log(json.dumps({"sharded": [{k: r[k] for k in (
            "rank", "device", "serve", "train", "train_fused_pos",
            "swin_backbone", "swin_train")}
            for r in sharded],
            "grid": args.grid, "backend": args.backend}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        kernel_results = kernel_phase(gen)
        kernel_results.update(msda_phase(gen))
    kernel_results.update(bwd_kernel_phase(gen))
    kernel_results.update(pos_bwd_kernel_phase(gen))
    kernel_results.update(msda_bwd_phase(gen))
    kernel_results.update(masked_phase(gen))
    row0_fwd, row0_bwd, row0_pos = row0_phase(gen)
    kernel_results["window_attention"] += row0_fwd
    kernel_results["window_attention_bwd"] += row0_bwd
    kernel_results["window_attention_pos_bwd"] += row0_pos
    tile_fwd, tile_bwd = msda_tile_phase(gen)
    kernel_results["msda_taps"] += tile_fwd
    kernel_results["msda_taps_bwd"] += tile_bwd
    log("phase 2 kernels: every kernel matches its plain version "
        "(f32 and bf16)")

    model, pair, serve = serve_phase()
    log("phase 3 serving path: " + json.dumps(serve))
    parity = parity_phase()
    log("phase 3 f32 kernels vs plain versions: " + json.dumps(parity))
    request_profile = profile_phase("request", lambda: predict(model, *pair))
    log("phase 6 request breakdown: " + json.dumps(request_profile))
    del model

    model, pair, swin_serve = serve_phase(swin=True)
    log("phase 3 swin serving path: " + json.dumps(swin_serve))
    taps = tap_oob_fractions(model, pair)
    log("phase 3 swin tap-path extractors: " + json.dumps(taps))
    if not all(t["taps"] for t in taps) or len(taps) != 4:
        fail(f"a swin extractor missed the tap path: {taps}")
    swin_parity = parity_phase(swin=True)
    log("phase 3 swin f32 kernels vs plain versions: " + json.dumps(swin_parity))
    swin_profile = profile_phase("swin request", lambda: predict(model, *pair))
    log("phase 6 swin request breakdown: " + json.dumps(swin_profile))
    del model

    stages = stage_grad_phase()
    log("phase 4 stage gradients, kernels vs plain versions (f32): "
        + json.dumps(stages))
    swin_grads = swin_grad_phase()
    log("phase 4 swin backbone gradients, kernels vs plain versions (f32): "
        + json.dumps(swin_grads))
    torch.cuda.empty_cache()

    step, batch, train = train_phase()
    log("phase 5 training path: " + json.dumps(train))
    step_profile = profile_phase("train step", lambda: step(batch))
    log("phase 6 training-step breakdown: " + json.dumps(step_profile))
    del step, batch
    torch.cuda.empty_cache()
    with fused_pos():
        step, batch, train_pos = train_phase(fused=True)
        log("phase 5 training path, NMRF_FUSED_POS=1: " + json.dumps(train_pos))
        log("phase 5 NMRF_FUSED_POS=1 against the default step: " + json.dumps(
            {k: [train_pos[k], train[k]] for k in ("step_ms", "peak_mem_gb")}))
        pos_profile = profile_phase("train step NMRF_FUSED_POS=1",
                                    lambda: step(batch))
        log("phase 6 NMRF_FUSED_POS=1 training-step breakdown: "
            + json.dumps(pos_profile))
    del step, batch
    torch.cuda.empty_cache()
    step, batch, swin_train = train_phase(swin=True)
    log("phase 5 swin training path: " + json.dumps(swin_train))
    swin_step_profile = profile_phase("swin train step", lambda: step(batch))
    log("phase 6 swin training-step breakdown: " + json.dumps(swin_step_profile))
    kernel_results["msda_taps_bwd"] += msda_bwd_main_path_phase(step, batch)
    del step, batch
    torch.cuda.empty_cache()

    t_shard = time.perf_counter()
    sharded = sharded_phase(args.grid, args.backend)
    log(f"phase 7 sharded path: {time.perf_counter() - t_shard:.1f} s; "
        + json.dumps([{k: r[k] for k in ("rank", "device", "serve", "train",
                                         "train_fused_pos")}
                      for r in sharded]))
    log_sharded_swin(sharded)
    t_swin = time.perf_counter()
    swin_data = swin_data_phase()
    log(f"phase 7 swin data-parallel path: {time.perf_counter() - t_swin:.1f} s; "
        "both ranks report the same losses and msda_tap_oob: "
        + json.dumps(swin_data[0]["losses"]))
    scaling = scaling_phase()
    log(f"phase 7c weak-scaling bench: {scaling['seconds']:.1f} s "
        f"({scaling['card']}); " + json.dumps(scaling["rows"]))
    t_entry = time.perf_counter()
    entry = entry_point_phase()
    log(f"phase 8 entry point: {time.perf_counter() - t_entry:.1f} s; "
        f"ms/step {json.dumps(entry['ms_per_step'])}, checkpoint save "
        f"{entry['save_s']:.3f} s, restore {json.dumps(entry['restore_s'])} s, "
        f"eval {entry['eval_ms_per_frame']:.2f} ms/frame ({gpu_identity()}); "
        + json.dumps(entry))
    t_diag = time.perf_counter()
    diagnostics = diagnostics_phase()
    log(f"phase 8 diagnostics: {time.perf_counter() - t_diag:.1f} s "
        f"({gpu_identity()}); " + json.dumps(diagnostics))
    t_serve = time.perf_counter()
    serving = serving_phase()
    log(f"phase 9 serving entry points: {time.perf_counter() - t_serve:.1f} s; "
        + json.dumps(serving))
    torch.cuda.empty_cache()
    t_bench = time.perf_counter()
    benches = bench_phase(args.flops_out)
    log(f"phase 10 measurement entry points: "
        f"{time.perf_counter() - t_bench:.1f} s ({gpu_identity()}); "
        + json.dumps(benches))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")

    counts = dict(serve["launches"])
    counts.update({k: train["launches"][k]
                   for k in ("window_attention_bwd", "stripe_attention_bwd")})
    counts["msda_taps"] = swin_serve["launches"]["msda_taps"]
    counts["masked_attention"] = sharded[0]["serve"]["launches"]["masked_attention"]
    counts["masked_attention_bwd"] = \
        sharded[0]["train"]["launches"]["masked_attention_bwd"]
    counts["window_attention_pos_bwd"] = \
        train_pos["launches"]["window_attention_pos_bwd"]
    counts["msda_taps_bwd"] = swin_train["launches"]["msda_taps_bwd"]
    line = kernels_line(kernel_results, counts)
    log("phase 10 kernels' bound operation counts (computed, not measured) "
        "and their share of the frame's or step's FLOPs: "
        + json.dumps(kernel_flop_shares(kernel_results, benches)))
    log(gpu_identity())
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
