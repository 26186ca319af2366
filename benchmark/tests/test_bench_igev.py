"""The IGEV-Stereo serving cell as data: its traffic, configuration and
limits in a throwaway root (``tiny_igev``), rehearsed with ``--device
cpu`` at 60x124 and 4 iterations, float32 on both sides; the repository
cell's generator keeps what its limits compare; the control (the float8
reference) and each planted fault (the GEV's lookup a tap off, a feature
gate skipped, the all-pairs volume over sqrt(C)) come out not
``correct``; a package whose configuration lacks IGEV-Stereo refuses the
cell at once; the readers of the ``nmrf::igev.*`` ranges and the volume
stage's roofline give known answers on a hand-built chrome trace, and
None without device events or ranges; ``arith_igev``'s convolution FLOPs
equal ``FlopCounterMode``'s on the reference's volume stage, and its
volume products the count of upstream's loop."""

import json

import pytest
import torch

from benchmark import arith, arith_igev, harness, run
from benchmark.reference import igev_stereo
from benchmark.tests import tiny_igev

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
CELL = "tiny_igev_stream"
SPEC = {"RAFT.HIDDEN_DIMS": [128, 128, 128], "RAFT.N_DOWNSAMPLE": 2,
        "RAFT.CORR_LEVELS": 2, "RAFT.CORR_RADIUS": 4, "RAFT.VALID_ITERS": 1,
        "IGEV.MAX_DISP": 192}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_igev.write(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_from_files(root, trace, capsys):
    result = run.main(["--workload", CELL, "--seed", str(2 ** 31 + 11),
                       "--seconds", "1.0", "--trace", str(trace), "--device",
                       "cpu", "--root", str(root)], start=0.0)
    out, _ = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == set(tiny_igev.LIMITS)
    assert set(result["metrics"]) == ({"completed_test"} if trace else set())


def test_the_repository_cell_reads_what_the_generator_keeps():
    cell = harness.Cell(tiny_igev.tiny.ROOT, "igevstereo_kitti_stream")
    gen = cell.module("traffic", "serve_stream_igev").Generator(
        cell, 1, torch.device("cpu"))
    assert gen.keep_hidden == (1, 32) and gen.keep_disp == (8, 16, 24, 32)
    assert gen.padded() == (384, 1248)
    assert set(cell.limits) == {"match_rel", "geo_rel", "init_disp_px",
                                "hidden_rel", "disp_lowres_px", "epe_px"}
    assert cell.config["reduced"] == []


@pytest.mark.parametrize("fault", (None,) + igev_stereo.FAULTS)
def test_control_and_faults_are_not_correct(root, fault):
    c = harness.Cell(root, CELL)
    gen = c.module("traffic", "serve_stream_igev").Generator(
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
        if "IGEV.MAX_DISP" in spec:
            raise KeyError("Non-existent config key: IGEV.MAX_DISP")
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
# features, 7 + 9 in the volume, 2 in the context, 4 in the pyramids, 11 +
# 13 and 17 (a graph launch) in the iterations (11 and 17 in their
# lookups) and 23 in the upsampling
IGEV_TRACE = [
    _x("nmrf::igev.features", "user_annotation", 0, 100),
    _launch(10, 1), _kernel(1000, 3, 1), _launch(50, 2), _kernel(1010, 5, 2),
    _x("nmrf::igev.volume", "user_annotation", 100, 20),
    _launch(105, 3), _kernel(1020, 7, 3), _launch(110, 9),
    _kernel(1030, 9, 9),
    _x("nmrf::igev.context", "user_annotation", 120, 5),
    _launch(121, 10), _kernel(1040, 2, 10),
    _x("nmrf::igev.corr", "user_annotation", 125, 5),
    _launch(126, 11), _kernel(1045, 4, 11),
    _x("nmrf::igev.update", "user_annotation", 130, 200),
    _x("nmrf::igev.lookup", "user_annotation", 135, 10),
    _launch(137, 4), _kernel(1050, 11, 4),
    _launch(150, 5), _kernel(1070, 13, 5),
    _x("nmrf::igev.lookup", "user_annotation", 220, 10),
    _launch(222, 6, "cudaGraphLaunch"), _kernel(1090, 17, 6),
    _x("nmrf::igev.upsample", "user_annotation", 330, 20),
    _launch(335, 8), _kernel(1110, 23, 8),
]
SHAPE = {"batch": 1, "height": 384, "width": 1248, "max_disp": 192}
IGEV_ANSWERS = {
    "igev_features_ms.serve": 0.008, "igev_volume_ms.serve": 0.016,
    "igev_update_ms.serve": 0.041, "igev_lookup_ms.serve": 0.028,
    "igev_volume_roofline.serve":
        100.0 * arith_igev.volume_least_ms(**SHAPE)[0] / 0.016}


def _read(tmp_path, name, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rec = {"trace": arith.Trace(path), "traced_frames": 1,
           "igev_volume": SHAPE}
    cell = harness.Cell(tiny_igev.tiny.ROOT, "igevstereo_kitti_stream")
    return cell.module("metrics", name).read(rec)


@pytest.mark.parametrize("name", sorted(IGEV_ANSWERS))
def test_igev_reader_known_answer(tmp_path, name):
    assert _read(tmp_path, name, IGEV_TRACE) == pytest.approx(
        IGEV_ANSWERS[name])


@pytest.mark.parametrize("name", sorted(IGEV_ANSWERS))
@pytest.mark.parametrize("case", ["no_device_events", "no_program_ranges"])
def test_igev_reader_reads_none(tmp_path, name, case):
    if case == "no_device_events":
        events = [e for e in IGEV_TRACE if e["cat"] not in arith.DEVICE_CATS]
    else:  # a program without the ranges, as the parent commit is
        events = [e for e in IGEV_TRACE if not e["name"].startswith("nmrf::")]
    assert _read(tmp_path, name, events) is None


@pytest.mark.parametrize("size", [(384, 1248), (64, 128)])
def test_volume_flops_match_the_counter_on_the_reference(size):
    """``arith_igev``'s convolutions against ``FlopCounterMode`` on the
    reference's volume stage on the meta device, and its volume products
    against upstream's loop (``build_gwc_volume``), counted directly."""
    from torch.utils.flop_counter import FlopCounterMode

    H, W = size
    h, w, d = H // 4, W // 4, 48
    model = igev_stereo.build(SPEC, "meta")
    feats = [torch.zeros(1, c, h // s, w // s, device="meta")
             for c, s in ((96, 1), (64, 2), (192, 4), (160, 8))]
    match = torch.zeros(1, 96, h, w, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.volume(feats, match, match)
    ops = arith_igev.volume_ops(1, H, W, 192)
    assert sum(op["flops"] for op in ops if op["kind"] == "conv") == \
        counter.get_total_flops()
    (vol,) = [op for op in ops if op["kind"] == "volume"]
    products = sum(h * (w - i) * 96 for i in range(d) if i < w)
    assert vol["flops"] == 2 * products
    least, bytes_ms, flops_ms = arith_igev.volume_least_ms(1, H, W, 192)
    assert least == max(bytes_ms, flops_ms) > 0
