"""The reader ``raft_graph_launches_per_iter.serve`` on hand-built chrome
traces: graph launches inside ``nmrf::raft.update`` over the iterations
run, 0 where the loop launched no graph, None without the range or
without device events."""

import json

import pytest

from benchmark import arith, harness
from benchmark.tests import tiny_raft

NAME = "raft_graph_launches_per_iter.serve"


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": args}


def _launch(ts, corr, name="cudaLaunchKernel", tid=1):
    return _x(name, "cuda_runtime", ts, 1, tid, correlation=corr)


def _kernel(ts, dur, corr):
    return _x(f"k{corr}", "kernel", ts, dur, 0, correlation=corr)


# two requests of two iterations each, two graphs an iteration; one graph
# launched on another thread, one outside the ranges (the upsampling's)
GRAPHS = [
    _x("nmrf::raft.encode", "user_annotation", 0, 100),
    _launch(10, 1), _kernel(1000, 3, 1),
    _x("nmrf::raft.update", "user_annotation", 120, 200),
    _launch(130, 2, "cudaGraphLaunch"), _kernel(1010, 5, 2),
    _launch(140, 3), _kernel(1020, 1, 3),
    _launch(150, 4, "cudaGraphLaunch_v10000"), _kernel(1030, 5, 4),
    _launch(200, 5, "cudaGraphLaunch"), _kernel(1040, 5, 5),
    _launch(210, 6, "cudaGraphLaunch", tid=2), _kernel(1050, 5, 6),
    _x("nmrf::raft.upsample", "user_annotation", 320, 20),
    _launch(325, 7, "cudaGraphLaunch"), _kernel(1060, 5, 7),
    _x("nmrf::raft.update", "user_annotation", 400, 200),
    *(e for i in range(4) for e in (
        _launch(410 + 10 * i, 8 + i, "cudaGraphLaunch"),
        _kernel(1100 + 10 * i, 5, 8 + i))),
]


def _read(tmp_path, events, iterations=4):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rec = {"trace": arith.Trace(path), "traced_frames": 2,
           "raft_iterations": iterations}
    cell = harness.Cell(tiny_raft.tiny.ROOT, "raftstereo_kitti_stream")
    return cell.module("metrics", NAME).read(rec)


def test_graph_launches_per_iteration(tmp_path):
    assert _read(tmp_path, GRAPHS) == pytest.approx(2.0)


def test_no_graph_launch_reads_zero(tmp_path):
    eager = [e for e in GRAPHS if not e["name"].startswith("cudaGraph")]
    assert _read(tmp_path, eager) == 0


@pytest.mark.parametrize("case", ["no_range", "no_device_events",
                                  "no_iterations"])
def test_reads_none(tmp_path, case):
    events, iterations = GRAPHS, 4
    if case == "no_range":
        events = [e for e in GRAPHS if e["name"] != "nmrf::raft.update"]
    elif case == "no_device_events":
        events = [e for e in GRAPHS if e["cat"] not in arith.DEVICE_CATS]
    else:
        iterations = 0
    assert _read(tmp_path, events, iterations) is None
