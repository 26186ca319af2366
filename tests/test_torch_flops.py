"""The port's FLOP count (``nmrf_tpu_torch/tools/flops.py``) against the JAX
tool's (``tools/flops.py``: XLA's cost analysis of the golden path), on the
CPU at 64x128, default widths.

XLA counts a layer scan's body once, so the JAX count is compared at one
layer per NMP stage; the port counts every layer, which the depth test
holds (exactly linear in the layers).  The forward agrees within 3% (the
port +0.27%: XLA counts elementwise work the torch counter does not, and
not every matmul alike); the training step within 4% (the port -3.7% at
batch 1, -3.5% at batch 2: XLA also counts the backward's elementwise work
and AdamW's).  Each operator's flop formula equals the counter's count of
its plain version at the same shapes.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from nmrf_tpu.config import get_cfg as jax_get_cfg
from nmrf_tpu_torch.ops import attention as A
from nmrf_tpu_torch.ops import msda
from nmrf_tpu_torch.tools import flops
from tools import flops as jax_flops

H, W = 64, 128
FWD_RTOL = 0.03    # measured: +0.27%
TRAIN_RTOL = 0.04  # measured: -3.73% (batch 1), -3.48% (batch 2)


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs a test process per core or so."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def layer_opts(L):
    return ["NMP.NUM_PROP_LAYERS", str(L), "NMP.NUM_INFER_LAYERS", str(L),
            "NMP.NUM_REFINE_LAYERS", str(L),
            "SOLVER.LOSS_WEIGHTS", str([1.0] * L + [2.0] * L),
            "DATASETS.CROP_SIZE", f"({H}, {W})"]


def jax_cfg(L):
    """``tools/flops.py:make_cfg(golden=True)`` at L layers a stage and the
    64x128 crop."""
    cfg = jax_get_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.USE_PALLAS = False
    cfg.TPU.MSDA_TAP_RADIUS = 0
    cfg.TPU.REMAT = False
    cfg.DATASETS.CROP_SIZE = (H, W)
    cfg.NMP.NUM_PROP_LAYERS = cfg.NMP.NUM_INFER_LAYERS = L
    cfg.NMP.NUM_REFINE_LAYERS = L
    cfg.SOLVER.LOSS_WEIGHTS = [1.0] * L + [2.0] * L
    cfg.freeze()
    return cfg


def port_forward(L):
    return flops.count_inference(flops.make_cfg(opts=layer_opts(L)), H, W,
                                 "cpu")


def test_forward_count_matches_jax_golden():
    port, shape = port_forward(1)
    jax, jax_shape = jax_flops.count_inference(jax_cfg(1), H, W)
    assert shape == list(jax_shape[1:])
    assert abs(port - jax) <= FWD_RTOL * jax, (port, jax)


def test_forward_count_every_layer():
    """Exactly linear in the layers a stage: no layer counted once for all
    (XLA's scan undercount)."""
    c1, c2, c5 = (port_forward(L)[0] for L in (1, 2, 5))
    assert c2 > c1
    assert c5 - c1 == 4 * (c2 - c1)


@pytest.mark.parametrize("B", [1, 2])
def test_train_step_count_matches_jax(B):
    port = flops.count_train_step(flops.make_cfg(opts=layer_opts(1)), B, "cpu")
    jax = jax_flops.count_train_step(jax_cfg(1), B)
    assert abs(port - jax) <= TRAIN_RTOL * jax, (port, jax)


def test_train_step_extrapolation():
    cfg = flops.make_cfg(opts=layer_opts(1))
    rec = flops.train_step_flops(cfg, 8, "cpu")
    f1, f2 = rec["flops_b1"], rec["flops_b2"]
    assert rec["flops_per_step"] == f1 + 7 * (f2 - f1)
    assert rec["per_sample_flops"] == f2 - f1 > 0
    # nothing the counter counts is independent of the batch (AdamW and the
    # clip are elementwise)
    assert rec["batch_independent_flops"] == 0


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))


def _window_case(N, ws, shift, candidate_mask, heads=2, hd=16, Hp=12, Wp=24):
    rng = np.random.RandomState(0)
    qkv = _rand(rng, 2, Hp, Wp, N, 3 * heads * hd)
    table = _rand(rng, (2 * ws - 1) ** 2, 3 * heads * hd, scale=0.02)
    args = (qkv, table, shift, (ws, ws), heads, candidate_mask, 0, None)
    return (A.window_attention_plain, torch.ops.nmrf.window_attention, args,
            flops.window_attention_flops(qkv.shape, (ws, ws), heads))


def _stripe_case(H_sp, W_sp, N=4, heads=2, hd=16, Hp=8, Wp=12):
    rng = np.random.RandomState(1)
    q, k, v = (_rand(rng, 1, Hp, Wp, N, heads * hd) for _ in range(3))
    args = (q, k, v, H_sp, W_sp, heads)
    return (A.stripe_attention_plain, torch.ops.nmrf.stripe_attention, args,
            flops.stripe_attention_flops(q.shape, H_sp, W_sp, heads))


def _msda_case(f, M=2, D=8, P=4, radius=2):
    rng = np.random.RandomState(2)
    value = _rand(rng, 1, 4, 6, M * D)
    dx, dy = (_rand(rng, 1, 4 * f, 6 * f, M * P, scale=2.0) for _ in range(2))
    aw = _rand(rng, 1, 4 * f, 6 * f, M * P).abs()
    return (msda.msda_taps_plain, torch.ops.nmrf.msda_taps,
            (value, dx, dy, aw, M, radius), 0)


OPERATOR_CASES = {
    "window inference N4 ws6 shift3": lambda: _window_case(4, 6, 3, True),
    "window refinement N1 ws4 shift2": lambda: _window_case(1, 4, 2, False),
    "window ws6 shift0": lambda: _window_case(4, 6, 0, True),
    "stripe rows": lambda: _stripe_case(1, 12),
    "stripe columns": lambda: _stripe_case(8, 1),
    "msda taps f1": lambda: _msda_case(1),
    "msda taps f2": lambda: _msda_case(2),
}


@pytest.mark.parametrize("case", OPERATOR_CASES)
def test_operator_formula_matches_plain_count(case):
    """The formula, called directly and through the counter on the
    operator (meta tensors: its fake implementation), equals the counter's
    count of the operator's plain version on CPU tensors."""
    plain, op, args, formula = OPERATOR_CASES[case]()
    with FlopCounterMode(display=False) as counter:
        plain(*args)
    want = counter.get_total_flops()
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with FlopCounterMode(display=False) as counter:
        op(*meta)
    assert formula == want
    assert counter.get_total_flops() == want
    if "msda" not in case:
        assert want > 0
