"""``python -m nmrf_tpu_torch.train`` end to end on the CPU (the port's
counterpart of ``tests/test_train_cli.py``; not marked slow: the port has
no compile step).

* 4 training steps on random-dot stereograms at 32x64 with an evaluation
  at step 4, a resume to step 6 that continues the step count, and
  ``--eval-only`` from the last checkpoint printing the ``copypaste:``
  metrics;
* a 2-process gloo world (``torchrun``'s environment) of 2 steps on a
  2 x 1 (data) grid with an evaluation: both ranks log the same losses,
  and rank 0 alone writes the config and the checkpoints.
"""

import os
import os.path as osp
import re
import socket
import subprocess
import sys

from nmrf_tpu_torch.utils.checkpoint import restore_checkpoint

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

BASE_OPTS = [
    "DATASETS.TRAIN", "('synthetic_4x32x64',)",
    "DATASETS.TEST", "['synthetic_1x32x64']",
    "TEST.EVAL_THRESH", "[['1.0']]",
    "TEST.EVAL_MAX_DISP", "[64]",
    "TEST.EVAL_ONLY_VALID", "[True]",
    "TEST.EVAL_PROP", "[False]",
    "TEST.EVAL_PERIOD", "4",
    "DPN.MAX_DISP", "64",
    "SOLVER.MAX_DISP", "48",
    "SOLVER.IMS_PER_BATCH", "2",
    "SOLVER.LATEST_CHECKPOINT_PERIOD", "2",
    "SOLVER.CHECKPOINT_PERIOD", "100",
    "DATALOADER.NUM_WORKERS", "0",
    "TPU.EVAL_BUCKET", "32",
]


def _env(**extra):
    path = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, OMP_NUM_THREADS="2",
                PYTHONPATH=REPO + (os.pathsep + path if path else ""), **extra)


def _run(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "nmrf_tpu_torch.train", "--device", "cpu"] + args,
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=600)


def test_train_resume_eval_only(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    r = _run(["--checkpoint-dir", ckpt] + BASE_OPTS + ["SOLVER.MAX_ITER", "4"],
             str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    log = r.stderr + r.stdout
    assert "Training done" in log and "copypaste:" in log
    assert osp.exists(osp.join(ckpt, "config.yaml"))
    state, step = restore_checkpoint(ckpt)
    assert step == 4 and state["step"] == 4

    r = _run(["--checkpoint-dir", ckpt] + BASE_OPTS
             + ["SOLVER.MAX_ITER", "6", "SOLVER.RESUME", ckpt], str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert restore_checkpoint(ckpt)[1] == 6
    # the step count continued: the first logged step is 5, and the
    # rolling latest save of step 4 is pruned
    assert "Epoch: [2] [0/2]" in r.stdout
    assert sorted(n for n in os.listdir(ckpt) if n.startswith("step_")) == [
        "step_00000006"]

    r = _run(["--checkpoint-dir", str(tmp_path / "eval"), "--eval-only"]
             + BASE_OPTS + ["SOLVER.RESUME", ckpt], str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    values = [line for line in r.stdout.splitlines() if "copypaste:" in line]
    names = values[1].split("copypaste: ")[1].split(",")
    epe = float(values[2].split("copypaste: ")[1].split(",")[names.index("epe")])
    assert 0 < epe < 64


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_world(tmp_path):
    port = str(_free_port())
    opts = BASE_OPTS + ["DATASETS.TEST", "['synthetic_2x32x64']",
                        "TEST.EVAL_PERIOD", "2", "SOLVER.MAX_ITER", "2"]
    procs = []
    for rank in range(2):
        env = _env(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nmrf_tpu_torch.train", "--device", "cpu",
             "--checkpoint-dir", str(tmp_path / f"rank{rank}")] + opts,
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0])
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(o[-2000:] for o in outs)

    def totals(path):
        with open(path) as f:
            return re.findall(r"  total: ([0-9.]+)", f.read())

    rank0, rank1 = str(tmp_path / "rank0"), str(tmp_path / "rank1")
    assert totals(osp.join(rank0, "log.txt")) == totals(
        osp.join(rank1, "log.txt.rank1")) != []
    assert sorted(n for n in os.listdir(rank0) if not n.startswith("events")) == [
        "config.yaml", "latest.txt", "log.txt", "step_00000002"]
    assert os.listdir(rank1) == ["log.txt.rank1"]
    assert "copypaste:" in outs[0]
