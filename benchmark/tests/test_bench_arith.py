"""The frozen yardstick arithmetic: timing window, percentiles and rates,
the chrome-trace reading, and the window-attention roofline."""

import json

import numpy as np
import pytest
import torch

from benchmark import arith


def test_window_times_the_block_on_the_cpu():
    with arith.Window("cpu") as w:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert w.wall_ms > 0 and w.ms == w.wall_ms


@pytest.mark.parametrize("q", [0, 50, 90, 95, 100])
def test_percentile_is_numpys_linear_rule(q):
    values = np.random.default_rng(3).exponential(40.0, 101)
    expected = np.percentile(values, q)
    assert arith.percentile(values, q) == pytest.approx(expected)


def test_rate():
    assert arith.rate(500, 20.0) == 25.0


def _event(name, cat, ts, dur, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


@pytest.fixture
def trace(tmp_path):
    """Host ranges A [0, 100) and B [100, 200); kernels launched in each;
    a copy; device busy [10, 40) U [30, 60) U [150, 170) (us)."""
    events = [
        _event("A", "user_annotation", 0, 100),
        _event("B", "user_annotation", 100, 100),
        _event("aten::mm", "cpu_op", 60, 80),
        _event("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=1),
        _event("cudaLaunchKernel", "cuda_runtime", 20, 1, correlation=2),
        _event("cudaMemcpyAsync", "cuda_runtime", 120, 1, correlation=3),
        _event("window_attention_mma_kernel", "kernel", 10, 30, correlation=1),
        _event("gemm_kernel", "kernel", 30, 30, correlation=2),
        _event("Memcpy HtoD", "gpu_memcpy", 150, 20, correlation=3),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return arith.Trace(path)


def test_trace_busy_idle_and_window(trace):
    assert trace.busy_ms() == pytest.approx(0.070)  # 50 + 20 us
    assert trace.window_ms() == pytest.approx(0.200)
    assert trace.idle_share() == pytest.approx(1 - 70 / 200)


def test_trace_kernel_and_copy_ms(trace):
    assert trace.kernel_ms(("window_attention",)) == pytest.approx(0.030)
    assert trace.kernel_ms(**arith.HOST_COPY) == pytest.approx(0.020)
    assert trace.kernel_ms() == pytest.approx(0.080)


def test_host_copies_leave_out_the_device_side_copies(tmp_path):
    events = [
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0, 20),
        _event("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 40, 10),
        _event("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 60, 5),
        _event("Memset (Device)", "gpu_memset", 70, 5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert arith.Trace(path).kernel_ms(**arith.HOST_COPY) == \
        pytest.approx(0.030)


def test_trace_split_by_ranges(trace):
    ms = trace.split_by_ranges(("A", "B"))
    assert ms == pytest.approx({"A": 0.060, "B": 0.020, "unattributed": 0.0})
    unattributed = trace.split_by_ranges(("B",))["unattributed"]
    assert unattributed == pytest.approx(0.060)


def test_trace_top_ops_and_idle_gaps(trace):
    assert trace.top_ops(2) == [["gemm_kernel", 30e-6],
                                ["window_attention_mma_kernel", 30e-6]]
    # one gap, 60 -> 150 us, its middle (105) inside B and aten::mm
    assert trace.idle_gaps() == [["aten::mm", pytest.approx(90e-6)]]


def test_window_bound_by_hand():
    """Inference at KITTI 1/8 (48 x 156 padded), 4 candidates, window 6,
    C 128, 4 heads, bf16: T = 144, P = 36, 208 windows."""
    B, Hp, Wp, N, ws, C, h = 1, 48, 156, 4, 6, 128, 4
    T, P, hd, G = 144, 36, 32, 208
    tokens = 48 * 156 * 4
    table = 121 * 384 * 4
    nbytes = tokens * 4 * C * 2 + table
    ops = G * h * hd * (4 * T * T + 6 * T * P)
    by_bytes, by_ops = arith.window_bound(B, Hp, Wp, N, ws, C, h)
    assert by_bytes == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert by_ops == pytest.approx(ops / 989e12 * 1e3)
    assert ops == 3_036_413_952  # one Inference layer of a KITTI frame
    bwd_bytes, bwd_ops = arith.window_bound(B, Hp, Wp, N, ws, C, h, True)
    assert bwd_bytes == pytest.approx((tokens * 7 * C * 2 + 2 * table)
                                      / 3.35e12 * 1e3)
    assert bwd_ops == pytest.approx(G * h * (10 * T * T * hd
                                             + 16 * T * P * hd) / 989e12 * 1e3)
    calls = [((B, Hp, Wp, N, 3 * C), ws, h)] * 2
    assert arith.least_ms(calls) == pytest.approx(2 * max(by_bytes, by_ops))
