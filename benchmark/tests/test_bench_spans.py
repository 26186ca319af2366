"""The readers of the program's own ranges (``benchmark/spans.py`` and the
eight metrics on it): known answers on a hand-built chrome trace, None
where the trace has no device events or the program no ranges, and the
backward's attribution on a real CPU trace of the tiny resnet train
cell."""

import collections
import json

import pytest
import torch

from benchmark import arith, harness, spans
from benchmark.tests import tiny

MAIN, AUTOGRAD = 1, 2


def x(name, cat, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": args}


def launch(ts, corr, tid=MAIN, name="cudaLaunchKernel", cat="cuda_runtime"):
    return x(name, cat, ts, 1, tid, correlation=corr)


def kernel(ts, dur, corr=None):
    return x(f"k{corr}", "kernel", ts, dur, 0,
             **({} if corr is None else {"correlation": corr}))


def ann(name, ts, dur, tid=MAIN):
    return x(name, "user_annotation", ts, dur, tid)


def node(name, ts, dur, seq=None):
    args = {} if seq is None else {"Sequence number": seq}
    return x(f"autograd::engine::evaluate_function: {name}", "cpu_op", ts,
             dur, AUTOGRAD, **args)


def op(name, ts, seq, dur=5):
    return x(name, "cpu_op", ts, dur, **{"Sequence number": seq})


SERVE = [
    ann("nmrf::predict", 0, 100),
    ann("nmrf::predict.prep", 0, 10), ann("nmrf::predict.copy_in", 10, 10),
    ann("nmrf::predict.forward", 20, 50), ann("nmrf::cost_volume", 30, 10),
    ann("nmrf::predict.wait", 70, 20), ann("nmrf::predict.copy_out", 90, 10),
    launch(15, 4, name="cudaMemcpyAsync"), x("Memcpy HtoD", "gpu_memcpy",
                                             300, 2, 0, correlation=4),
    launch(32, 1), kernel(310, 3, 1),
    launch(50, 2, name="cudaLaunchKernelExC"), kernel(320, 5, 2),
    launch(60, 3, name="cuLaunchKernel", cat="cuda_driver"),
    kernel(330, 7, 3),
    launch(150, 5), kernel(340, 11, 5),
]
# host ms a request: prep + copy in + copy out, the forward; device ms
# launched in the cost volume; launches inside predict
SERVE_ANSWERS = {"predict_host_ms.serve": 0.03, "issue_ms.serve": 0.05,
                 "cost_volume_ms.serve": 0.003, "launches.serve": 3}

TRAIN = [
    ann("nmrf::step", 0, 1000), ann("nmrf::forward", 0, 300),
    ann("nmrf::backbone", 0, 100), op("aten::convolution", 10, 5),
    launch(12, 10), kernel(2000, 1, 10),
    ann("nmrf::dpn", 100, 100), op("aten::mul", 110, 6),
    # an op that made no node records the number the next node takes
    op("aten::detach", 150, 7),
    ann("nmrf::inference", 200, 100), op("aten::add", 210, 7),
    ann("nmrf::loss", 300, 100), op("aten::mean", 310, 8),
    ann("nmrf::backward", 400, 500),
    launch(402, 19), kernel(2090, 3, 19),  # the seed gradient: no node
    node("MeanBackward0", 410, 20, 8), launch(415, 20, AUTOGRAD),
    kernel(2100, 2, 20),
    node("AddBackward0", 440, 20, 7), launch(445, 21, AUTOGRAD),
    kernel(2200, 11, 21),
    node("MulBackward0", 470, 20, 6), launch(475, 22, AUTOGRAD),
    kernel(2300, 13, 22),
    node("ConvolutionBackward0", 500, 40, 5), launch(505, 23, AUTOGRAD),
    kernel(2400, 17, 23), launch(520, 24, AUTOGRAD, "cuLaunchKernel",
                                 "cuda_driver"),
    kernel(2500, 19, 24),
    node("torch::autograd::AccumulateGrad", 550, 10),
    launch(555, 25, AUTOGRAD), kernel(2600, 23, 25),
    kernel(2650, 29),  # its launch lost: goes where the kernel before went
    ann("nmrf::optimizer", 900, 100), launch(910, 26), kernel(2700, 31, 26),
    launch(1100, 27), kernel(2800, 37, 27),
]
TRAIN_ANSWERS = {"backbone_bwd_ms.train": 0.036, "dpn_bwd_ms.train": 0.013,
                 "nmp_bwd_ms.train": 0.011, "launches.train": 9}
BACKWARD = {"nmrf::backbone": 0.036, "nmrf::cost_volume": 0.0,
            "nmrf::dpn": 0.013, "nmrf::inference": 0.011,
            "nmrf::refinement": 0.0, "nmrf::loss": 0.002,
            "unattributed": 0.055}


def rec_of(tmp_path, events, units, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return {"trace": arith.Trace(path), units: 1}


def reader(name):
    return harness.Cell(tiny.ROOT, "resnet_kitti_stream").module("metrics",
                                                                 name)


@pytest.mark.parametrize("name", sorted({**SERVE_ANSWERS, **TRAIN_ANSWERS}))
def test_reader_known_answer(tmp_path, name):
    serve = name in SERVE_ANSWERS
    rec = rec_of(tmp_path, SERVE if serve else TRAIN,
                 "traced_frames" if serve else "traced_steps")
    answer = (SERVE_ANSWERS if serve else TRAIN_ANSWERS)[name]
    assert reader(name).read(rec) == pytest.approx(answer)


def test_backward_by_stage_sums_to_the_backward_range(tmp_path):
    trace = rec_of(tmp_path, TRAIN, "traced_steps")["trace"]
    ms = spans.backward_ms(trace)
    assert ms == pytest.approx(BACKWARD)
    whole = trace.split_by_ranges(("nmrf::backward",))["nmrf::backward"]
    assert sum(ms.values()) == pytest.approx(whole)


@pytest.mark.parametrize("name", sorted({**SERVE_ANSWERS, **TRAIN_ANSWERS}))
@pytest.mark.parametrize("case", ["no_device_events", "no_program_ranges"])
def test_reader_reads_none(tmp_path, name, case):
    serve = name in SERVE_ANSWERS
    events = SERVE if serve else TRAIN
    if case == "no_device_events":
        events = [e for e in events if e["cat"] not in arith.DEVICE_CATS]
    else:  # a program without the ranges, as the parent commit is
        events = [e for e in events if not e["name"].startswith("nmrf::")]
    rec = rec_of(tmp_path, events,
                 "traced_frames" if serve else "traced_steps")
    assert reader(name).read(rec) is None


def test_backward_attribution_on_a_cpu_trace(tmp_path):
    """The tiny resnet train cell traced on the CPU: at least 90% of the
    backward's host time in autograd nodes goes to a stage or the loss."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = harness.Cell(tiny.write(tmp_path), "tiny_train")
        gen = cell.module("traffic", cell.traffic["generator"]).Generator(
            cell, 2 ** 31 + 9, torch.device("cpu"), trace=True)
        gen.setup()
        gen.measure(0.1)
        trace = gen.trace(tmp_path / "trace.json")["trace"]
    finally:
        torch.set_num_threads(n)
    ms = collections.Counter()
    for e, stage in spans.node_stages(trace):
        ms[stage] += float(e["dur"])
    assert set(ms) <= {*spans.STAGES, spans.LOSS, spans.UNATTRIBUTED}
    assert {"nmrf::backbone", "nmrf::dpn", "nmrf::inference",
            "nmrf::refinement", "nmrf::loss"} <= set(ms)
    assert ms[spans.UNATTRIBUTED] < 0.1 * sum(ms.values())
