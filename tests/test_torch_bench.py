"""The port's measurement entry points on the CPU at a small size: each
``main(argv)`` with ``--device cpu`` runs the plain versions and prints what
its JAX counterpart prints (the JSON keys of root ``bench.py`` and
``bench_train.py``, read from their source; the stage and part names of
``tools/bench_stages.py`` and ``tools/bench_swin_parts.py``); the trace
summary on a hand-written chrome trace; the tap-coverage check's exit code;
and every entry point's refusal to run without CUDA unless the CPU is asked
for.  The CPU's times are no device metric: only their shape is checked.
"""

import ast
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nmrf_tpu_torch import bench, bench_train
from nmrf_tpu_torch.tools import (bench_loader, bench_photometric,
                                  bench_stages, bench_swin_parts,
                                  check_tap_coverage, flops, profile_model,
                                  profile_train)

ROOT = Path(__file__).resolve().parent.parent
SWIN = str(ROOT / "configs" / "sceneflow_swint.yaml")
# the small model of tests/test_export.py:17-19, 2 layers a stage
SMALL = ["DPN.MAX_DISP", "64", "SOLVER.MAX_DISP", "48",
         "NMP.NUM_PROP_LAYERS", "2", "NMP.NUM_INFER_LAYERS", "2",
         "NMP.NUM_REFINE_LAYERS", "2",
         "SOLVER.LOSS_WEIGHTS", "[1.0, 1.0, 2.0, 2.0]"]
CROP = ["SOLVER.IMS_PER_BATCH", "1", "DATASETS.CROP_SIZE", "(64, 128)"]


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    """Two intra-op threads (the suite runs a test process per core or so)
    and every frame 64x128."""
    monkeypatch.setenv("BENCH_HW", "64x128")
    monkeypatch.setenv("PROFILE_SIZE", "64x128")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_json_keys(script):
    """The keys of the JSON line a root JAX script prints: those of the dict
    literal it passes to ``json.dumps``, or of its ``rec = {...}`` and
    ``rec["..."] = ...`` assignments, in source order."""
    keys = []

    def literal(d):
        return [k.value for k in d.keys if isinstance(k, ast.Constant)]

    for node in ast.walk(ast.parse((ROOT / script).read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "dumps" and isinstance(node.args[0], ast.Dict):
            keys += literal(node.args[0])
        elif isinstance(node, ast.Assign):
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == "rec" \
                    and isinstance(node.value, ast.Dict):
                keys += literal(node.value)
            elif isinstance(target, ast.Subscript) and getattr(
                    target.value, "id", "") == "rec":
                keys.append(target.slice.value)
    return keys


def stdout_json(capsys):
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    return [json.loads(line) for line in lines]


@pytest.mark.parametrize("config", ["resnet", "swin"])
def test_bench_json_line(config, capsys):
    extra = ["--config-file", SWIN] if config == "swin" else []
    res = bench.main(["--device", "cpu", "--repeat", "2"] + extra + SMALL)
    (rec,) = stdout_json(capsys)
    assert list(rec) == jax_json_keys("bench.py") \
        == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "kitti_1242x375_latency" + (
        "_sceneflow_swint" if extra else "")
    assert rec["unit"] == "ms/frame" and math.isfinite(rec["value"]) \
        and rec["value"] > 0
    assert rec["vs_baseline"] == round(90.0 / rec["value"], 3)
    assert len(res["wall_ms"]) == 2
    # on the CPU the wrappers take the plain versions: deployed = plain path
    assert res["deployed_flops"] == res["plain_flops"] > 0
    assert res["bytes"] > 0 and sum(res["launches"].values()) == 0


def test_bench_train_json_line_and_flops(capsys):
    res = bench_train.main(["--device", "cpu"] + SMALL + CROP)
    (rec,) = stdout_json(capsys)
    jax_keys = jax_json_keys("bench_train.py")
    # hbm_gb_per_step and mbu are optional in JAX and left out here
    assert list(rec) == [k for k in jax_keys
                         if k not in ("hbm_gb_per_step", "mbu")]
    assert rec["metric"] == "train_step_64x128_b1"
    assert all(math.isfinite(rec[k]) for k in list(rec)[1:] if k != "unit")
    cfg = flops.make_cfg(opts=SMALL + CROP)
    want = flops.train_step_flops(cfg, 1, "cpu")["flops_per_step"]
    assert res["flops"] == want
    assert rec["tflops_per_step"] == round(want / 1e12, 2)
    assert rec["mfu"] == round(flops.mfu(want, rec["value"]), 4)


def test_bench_train_two_process_world(tmp_path):
    """Under torchrun's variables (2 ranks, gloo on the CPU) the ranks form
    a 2 x 1 mesh of one global batch of 2; rank 0 alone prints the line,
    with one rank's share of the unsharded step's count and that card's
    MFU."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT)] + os.environ.get("PYTHONPATH", "").split(
                           os.pathsep)))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nmrf_tpu_torch.bench_train", "--device",
             "cpu"] + SMALL + ["SOLVER.IMS_PER_BATCH", "2",
                               "DATASETS.CROP_SIZE", "(64, 128)",
                               "TPU.MESH_DATA", "2"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300))
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [e[-2000:] for _, e in outs]
    lines = [[json.loads(x) for x in o.splitlines() if x.startswith("{")]
             for o, _ in outs]
    assert len(lines[0]) == 1 and lines[1] == []
    rec = lines[0][0]
    assert rec["metric"] == "train_step_64x128_b2" and math.isfinite(
        rec["total_loss"])
    assert "mesh (2, 1)" in outs[0][1]
    cfg = flops.make_cfg(opts=SMALL + CROP)
    want = flops.train_step_flops(cfg, 2, "cpu")["flops_per_step"]
    assert rec["tflops_per_step"] == round(want / 2 / 1e12, 2)
    (info,) = [json.loads(x.split("flops ", 1)[1]) for x in
               outs[0][1].splitlines() if x.startswith("bench_train: flops ")]
    assert info["step_flops"] == want and info["world"] == 2
    assert info["flops_per_rank"] == want / 2
    assert info["mfu"] == pytest.approx(
        flops.mfu(want / 2, info["wall_ms"]), rel=1e-12)
    assert rec["mfu"] == round(info["mfu"], 4)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_bench_stages(capsys):
    rows = bench_stages.main(["--device", "cpu"] + SMALL)
    printed = stdout_json(capsys)
    assert printed == rows
    # tools/bench_stages.py:115-121
    assert [r["stage"] for r in rows] == [
        "backbone", "costvol+dpn", "inference_nmp", "refinement_nmp",
        "sum_of_stages", "full_forward"]
    assert all(list(r) == ["stage", "ms"] and r["ms"] > 0 for r in rows)


def test_bench_swin_parts(capsys):
    rows = bench_swin_parts.main(["--iters", "2", "--device", "cpu"])
    assert stdout_json(capsys) == rows
    # tools/bench_swin_parts.py:58-89
    assert [r["part"] for r in rows] == [
        "swin_adaptor_total", "swin_transformer", "deform_neck",
        "msda_core_l0", "msda_core_l1"]
    assert all(list(r) == ["part", "ms"] and r["ms"] > 0 for r in rows)


def test_flops_main(tmp_path):
    out = tmp_path / "FLOPS_H100.json"
    rec = flops.main(["--device", "cpu", "--out", str(out), "--infer-ms", "50",
                      "--train-ms", "200", "--fused-train-ms", "190"]
                     + SMALL + ["DATASETS.CROP_SIZE", "(64, 128)"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    cfg = flops.make_cfg(opts=SMALL + ["DATASETS.CROP_SIZE", "(64, 128)"])
    assert rec["inference_resnet"]["flops"] == \
        flops.count_inference(cfg, 64, 128, "cpu")[0]
    assert rec["inference_resnet"]["mfu"] == flops.mfu(
        rec["inference_resnet"]["flops"], 50.0)
    assert "mfu" not in rec["inference_swin"]
    step = rec["train_step_resnet"]
    assert step["flops_per_step"] == step["flops_b1"] + 7 * (
        step["flops_b2"] - step["flops_b1"])
    assert set(step) >= {"default", "fused_pos"}
    assert "default" not in rec["train_step_swin"]


def _trace(tmp_path):
    """A chrome trace: device kernels of K1, K2, K1b, K2b, B5, B5b and two
    library kernels, some overlapping, their launches inside two ranges."""
    def x(name, cat, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
                "ts": ts, "dur": dur, "args": args}

    kernels = [  # (name, ts, dur) in us
        ("void nmrf::window_attention_mma_kernel<__nv_bfloat16, 32, 9>", 100, 50),
        ("void nmrf::stripe_attention_mma_kernel<__nv_bfloat16, 32>", 140, 30),
        ("void nmrf::msda_taps_vec_kernel<__nv_bfloat16, 8>", 200, 10),
        ("void nmrf::window_bwd_mma_kernel<__nv_bfloat16, 32, 1>", 300, 40),
        ("void nmrf::window_dve_kernel<float>", 340, 5),
        ("void nmrf::stripe_bwd_dq_mma_kernel<__nv_bfloat16, 32>", 350, 20),
        ("void nmrf::stripe_bwd_dkv_mma_kernel<__nv_bfloat16, 32>", 360, 20),
        ("void nmrf::msda_bwd_gather_kernel<__nv_bfloat16, 8>", 400, 10),
        ("sm90_xmma_gemm_bf16bf16_bf16f32", 420, 30),
        ("void at::native::elementwise_kernel<128, 4>", 500, 10),
    ]
    events = [x("nmrf::forward", "user_annotation", 0, 230),
              x("nmrf::backward", "user_annotation", 230, 220),
              x("cpu work", "cpu_op", 0, 600)]
    for i, (name, ts, dur) in enumerate(kernels):
        launch = ts - 60 if i != 4 else None  # the d(ve) launch is lost
        if launch is not None:
            events.append(x("cudaLaunchKernel", "cuda_runtime", launch, 2,
                            correlation=i))
        events.append(x(name, "kernel", ts, dur, correlation=i))
    events.append(x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 580, 20))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_summarize_trace(tmp_path):
    rows, busy, idle, groups = profile_model.summarize_trace(_trace(tmp_path))
    assert groups["window_attention (K1)"] == (0.05, 1)
    assert groups["stripe_attention (K2)"] == (0.03, 1)
    assert groups["msda_taps (B5)"] == (0.01, 1)
    assert groups["window_attention_bwd (K1b)"] == pytest.approx((0.045, 2))
    assert groups["stripe_attention_bwd (K2b)"] == (0.04, 2)
    assert groups["msda_taps_bwd (B5b)"] == (0.01, 1)
    assert groups["matmul"] == (0.03, 1)
    assert groups["memcpy"] == (0.02, 1)
    assert groups["other elementwise"] == (0.01, 1)
    assert rows[0][2].startswith("void nmrf::window_attention_mma")
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    # union: [100, 170] [200, 210] [300, 345] [350, 380] [400, 410]
    # [420, 450] [500, 510] [580, 600] = 70+10+45+30+10+30+10+20 us
    assert busy == pytest.approx(0.225)
    assert idle == pytest.approx(1 - 0.225 / 0.6)
    split = profile_model.split_by_ranges(
        _trace(tmp_path), ("nmrf::forward", "nmrf::backward"))
    # launched 60 us before they run: K1, K2, B5 in the forward, the rest
    # in the backward; the launch of K1b's d(ve) kernel is missing, and the
    # memcpy has none: each takes its predecessor's range
    assert split == pytest.approx({"nmrf::forward": 0.09,
                                   "nmrf::backward": 0.155,
                                   "unattributed": 0.0})


def test_profilers(tmp_path, capsys):
    rows, busy, idle, groups = profile_model.main(
        ["--device", "cpu", "--out", str(tmp_path / "m")] + SMALL)
    assert (tmp_path / "m" / "trace.json").exists()
    # no device on the CPU: nothing to attribute
    assert rows == [] and busy == 0.0
    res = profile_train.main(["--device", "cpu", "--steps", "1", "--out",
                              str(tmp_path / "t")] + SMALL + CROP)
    assert set(res["split_ms"]) >= set(profile_train.RANGES)
    assert res["wall_ms"] > 0 and "by part" in capsys.readouterr().out


def test_host_benches(capsys):
    loader = bench_loader.main(["--device", "cpu", "--size", "4", "--batch", "2",
                                "--workers", "1", "--height", "64",
                                "--width", "128"])
    photo = bench_photometric.main(["--device", "cpu", "--iters", "2",
                                    "--height", "32", "--width", "64"])
    out = capsys.readouterr().out
    assert loader["threads"] > 0 and loader["processes"] > 0
    assert "threads:" in out and "processes:" in out
    assert set(photo) == {"pil", "native"} and min(photo.values()) > 0
    assert "native:" in out


def test_check_tap_coverage(tmp_path):
    from nmrf_tpu_torch.config import get_cfg
    from nmrf_tpu_torch.models import build_model

    argv = ["--device", "cpu", "--hw", "64x128", "--config-file", SWIN]
    assert check_tap_coverage.main(argv) == 0
    cfg = get_cfg()
    cfg.merge_from_file(SWIN)
    model = build_model(cfg, device="cpu")
    attn = model.backbone.neck.extractors[2].attn
    with torch.no_grad():  # every sample of one level 9 level pixels along x
        attn.sampling_offsets.bias.view(-1, 2)[:, 0] += 9.0
    path = tmp_path / "pushed.pth"
    torch.save({"model": model.state_dict()}, path)
    assert check_tap_coverage.main(argv + ["SOLVER.RESUME", str(path)]) == 1


ENTRY_POINTS = {
    "bench": bench.main, "bench_train": bench_train.main,
    "flops": flops.main, "profile_model": profile_model.main,
    "profile_train": profile_train.main, "bench_stages": bench_stages.main,
    "bench_swin_parts": bench_swin_parts.main,
    "bench_loader": bench_loader.main,
    "bench_photometric": bench_photometric.main,
    "check_tap_coverage": check_tap_coverage.main,
}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_needs_cuda_unless_cpu_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ENTRY_POINTS[name]([])


def test_boundary_bytes():
    """A view moves nothing; an op reads each input's distinct elements
    once (a broadcast axis once) and writes its output; an in-place op
    reads and writes its tensor."""
    x = torch.randn(4, 8)
    n = x.numel() * 4
    with flops.BoundaryBytes() as counter:
        x.view(8, 4).permute(1, 0)
        x + x                       # 2 reads, 1 write
        x.expand(3, 4, 8).sum(0)    # the broadcast read once, 1 write
        x.mul_(2.0)                 # read and write
    assert counter.bytes == 3 * n + 2 * n + 2 * n
    assert counter.by_op == {"aten.add": 3 * n, "aten.sum": 2 * n,
                             "aten.mul_": 2 * n}


def test_chained_ms_chains_on_the_previous_output():
    """Each call's first argument carries the previous output's zero
    token: the values are unchanged and the calls are counted."""
    from nmrf_tpu_torch.utils.benchmarks import chained_ms

    seen = []
    x = torch.arange(4.0)

    def fn(a, b):
        seen.append(a.clone())
        return a * b

    ms, wall = chained_ms(fn, x, torch.tensor(2.0), iters=5, wall=True)
    assert len(seen) == 6 and all(torch.equal(s, x) for s in seen)
    assert ms == wall > 0
    assert np.isfinite(ms)
