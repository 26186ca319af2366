"""The RAFT-Stereo serving cell as data: its traffic, configuration and
limits in a throwaway root (``tiny_raft``), rehearsed with ``--device
cpu`` at 60x124 and 4 iterations, float32 on both sides; the control (the
float8 reference) and each planted fault (a wrong GRU gate, half the
iterations, the coarsest level dropped) come out not ``correct``; and a
package whose configuration has no ``MODEL.ARCH`` refuses the cell at
once; the readers of the ``nmrf::raft.*`` ranges give known answers on a
hand-built chrome trace, and None without device events or ranges."""

import json

import pytest
import torch

from benchmark import arith, harness, run
from benchmark.reference import raft_stereo
from benchmark.tests import tiny_raft

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
CELL = "tiny_raft_stream"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_raft.write(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_from_files(root, trace, capsys):
    result = run.main(["--workload", CELL, "--seed", str(2 ** 31 + 11),
                       "--seconds", "1.0", "--trace", str(trace), "--device",
                       "cpu", "--root", str(root)], start=0.0)
    out, _ = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == set(tiny_raft.LIMITS)
    assert set(result["metrics"]) == ({"completed_test"} if trace else set())


def test_the_repository_cell_reads_what_the_generator_keeps():
    cell = harness.Cell(tiny_raft.tiny.ROOT, "raftstereo_kitti_stream")
    gen = cell.module("traffic", "serve_stream_raft").Generator(
        cell, 1, torch.device("cpu"))
    assert gen.keep_hidden == (1, 32) and gen.keep_disp == (8, 16, 24, 32)
    assert set(cell.limits) == {"fmap_rel", "corr_rel", "hidden_rel",
                                "disp_lowres_px", "epe_px"}


@pytest.mark.parametrize("fault", (None,) + raft_stereo.FAULTS)
def test_control_and_faults_are_not_correct(root, fault):
    c = harness.Cell(root, CELL)
    gen = c.module("traffic", "serve_stream_raft").Generator(
        c, 31, torch.device("cpu"))
    gen.inputs()
    numbers = gen.control() if fault is None else gen.fault(fault)
    correct, checks = harness.judge(numbers, c.limits)
    assert not correct
    assert max(v["value"] / v["limit"] for v in checks.values()) > 10


def test_a_package_without_the_architecture_refuses_at_once(root,
                                                            monkeypatch):
    from nmrf_tpu_torch import config

    def older(spec, seed):
        if "MODEL.ARCH" in spec:
            raise KeyError("Non-existent config key: MODEL.ARCH")
        return port_cfg(spec, seed)

    port_cfg = harness.port_cfg
    monkeypatch.setattr(harness, "port_cfg", older)
    built = []
    monkeypatch.setattr(config, "get_cfg", lambda: built.append(1))
    with pytest.raises(KeyError):
        run.main(["--workload", CELL, "--seed", "3", "--seconds", "0.5",
                  "--device", "cpu", "--root", str(root)], start=0.0)
    assert built == []


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": args}


def _launch(ts, corr, name="cudaLaunchKernel", cat="cuda_runtime"):
    return _x(name, cat, ts, 1, correlation=corr)


def _kernel(ts, dur, corr):
    return _x(f"k{corr}", "kernel", ts, dur, 0, correlation=corr)


# one request of two iterations: kernels of 3 + 5 us launched in the
# encoders, 7 in the volume, 11 + 13 and 17 + 19 in the two iterations
# (11 and 17 in their lookups) and 23 in the upsampling
RAFT_TRACE = [
    _x("nmrf::raft.encode", "user_annotation", 0, 100),
    _launch(10, 1), _kernel(1000, 3, 1), _launch(50, 2), _kernel(1010, 5, 2),
    _x("nmrf::raft.corr", "user_annotation", 100, 20),
    _launch(105, 3), _kernel(1020, 7, 3),
    _x("nmrf::raft.update", "user_annotation", 120, 200),
    _x("nmrf::raft.lookup", "user_annotation", 130, 10),
    _launch(132, 4), _kernel(1030, 11, 4),
    _launch(150, 5), _kernel(1050, 13, 5),
    _x("nmrf::raft.lookup", "user_annotation", 220, 10),
    _launch(222, 6), _kernel(1070, 17, 6),
    _launch(250, 7, "cuLaunchKernel", "cuda_driver"), _kernel(1090, 19, 7),
    _x("nmrf::raft.upsample", "user_annotation", 320, 20),
    _launch(325, 8), _kernel(1110, 23, 8),
]
RAFT_ANSWERS = {"raft_encode_ms.serve": 0.008, "raft_corr_ms.serve": 0.007,
                "raft_update_ms.serve": 0.060, "raft_lookup_ms.serve": 0.028,
                "raft_launches_per_iter.serve": 2}


def _read(tmp_path, name, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rec = {"trace": arith.Trace(path), "traced_frames": 1,
           "raft_iterations": 2}
    cell = harness.Cell(tiny_raft.tiny.ROOT, "raftstereo_kitti_stream")
    return cell.module("metrics", name).read(rec)


@pytest.mark.parametrize("name", sorted(RAFT_ANSWERS))
def test_raft_reader_known_answer(tmp_path, name):
    assert _read(tmp_path, name, RAFT_TRACE) == pytest.approx(
        RAFT_ANSWERS[name])


@pytest.mark.parametrize("name", sorted(RAFT_ANSWERS))
@pytest.mark.parametrize("case", ["no_device_events", "no_program_ranges"])
def test_raft_reader_reads_none(tmp_path, name, case):
    if case == "no_device_events":
        events = [e for e in RAFT_TRACE if e["cat"] not in arith.DEVICE_CATS]
    else:  # a program without the ranges, as the parent commit is
        events = [e for e in RAFT_TRACE if not e["name"].startswith("nmrf::")]
    assert _read(tmp_path, name, events) is None
