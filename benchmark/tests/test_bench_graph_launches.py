"""The reader ``graph_launches.serve`` on hand-built chrome traces: graph
launches inside ``nmrf::predict`` a traced request, 0 where the forward
launched no graph, None without the range or without device events."""

import json

import pytest

from benchmark import arith, harness
from benchmark.tests import tiny

NAME = "graph_launches.serve"


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": args}


def _launch(ts, corr, name="cudaLaunchKernel", tid=1):
    return _x(name, "cuda_runtime", ts, 1, tid, correlation=corr)


def _kernel(ts, dur, corr):
    return _x(f"k{corr}", "kernel", ts, dur, 0, correlation=corr)


# two requests: the first replays three graphs (one launched from another
# thread), the second two; one graph launched between the requests
GRAPHS = [
    _x("nmrf::predict", "user_annotation", 0, 100),
    _launch(10, 1), _kernel(1000, 3, 1),
    _launch(20, 2, "cudaGraphLaunch"), _kernel(1010, 5, 2),
    _launch(30, 3, "cudaGraphLaunch_v10000"), _kernel(1020, 5, 3),
    _launch(40, 4, "cudaGraphLaunch", tid=2), _kernel(1030, 5, 4),
    _launch(120, 5, "cudaGraphLaunch"), _kernel(1040, 5, 5),
    _x("nmrf::predict", "user_annotation", 200, 100),
    _launch(210, 6, "cudaGraphLaunch"), _kernel(1100, 5, 6),
    _launch(220, 7), _kernel(1110, 1, 7),
    _launch(230, 8, "cudaGraphLaunch"), _kernel(1120, 5, 8),
]


def _read(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rec = {"trace": arith.Trace(path), "traced_frames": 2}
    return harness.Cell(tiny.ROOT, "resnet_kitti_stream").module(
        "metrics", NAME).read(rec)


def test_graph_launches_a_request(tmp_path):
    assert _read(tmp_path, GRAPHS) == pytest.approx(2.5)


def test_no_graph_launch_reads_zero(tmp_path):
    eager = [e for e in GRAPHS if not e["name"].startswith("cudaGraph")]
    assert _read(tmp_path, eager) == 0


@pytest.mark.parametrize("case", ["no_range", "no_device_events"])
def test_reads_none(tmp_path, case):
    if case == "no_range":
        events = [e for e in GRAPHS if e["name"] != "nmrf::predict"]
    else:
        events = [e for e in GRAPHS if e["cat"] not in arith.DEVICE_CATS]
    assert _read(tmp_path, events) is None
