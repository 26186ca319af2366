"""``python -m nmrf_tpu_torch.train`` with the swin backbone under a
spatial mesh, end to end on the CPU: a 2-process gloo world
(``torchrun``'s environment) on a 1 x 2 (data, spatial) grid
(``TPU.MESH_SPATIAL 2``) takes 2 training steps on random-dot pairs at
96 x 64 and evaluates, the swin backbone on each rank's H tile of the
images (its first stage on tiles of 12 rows, the later ones whole, as the
log says).  Both ranks log the same losses, rank 0 alone writes the
config and the checkpoint, and the evaluation prints its metrics.
"""

import os
import os.path as osp
import re
import subprocess
import sys

from .test_torch_train_cli import BASE_OPTS, REPO, _env, _free_port


def test_swin_on_a_spatial_mesh(tmp_path):
    port = str(_free_port())
    opts = ["--config-file", osp.join(REPO, "configs", "sceneflow_swint.yaml")]
    opts += BASE_OPTS + [
        "DATASETS.TRAIN", "('synthetic_4x96x64',)",
        "DATASETS.TEST", "['synthetic_1x96x64']",
        "TEST.EVAL_PERIOD", "2", "SOLVER.MAX_ITER", "2",
        "NMP.NUM_PROP_LAYERS", "1", "NMP.NUM_INFER_LAYERS", "1",
        "NMP.NUM_REFINE_LAYERS", "1", "SOLVER.LOSS_WEIGHTS", "[1.0, 2.0]",
        "TPU.MESH_DATA", "1", "TPU.MESH_SPATIAL", "2"]
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
    assert [p.returncode for p in procs] == [0, 0], "\n".join(o[-3000:] for o in outs)

    def log_of(path):
        with open(path) as f:
            return f.read()

    rank0 = log_of(tmp_path / "rank0" / "log.txt")
    rank1 = log_of(tmp_path / "rank1" / "log.txt.rank1")
    totals = re.findall(r"  total: ([0-9.]+)", rank0)
    assert totals == re.findall(r"  total: ([0-9.]+)", rank1) != []
    for text in (rank0, rank1):
        assert "swin stages on H tiles of 2 ranks (first stage 12 rows a " \
            "tile): ['tile', 'whole', 'whole', 'whole']" in text
    assert sorted(n for n in os.listdir(tmp_path / "rank0")
                  if not n.startswith("events")) == [
        "config.yaml", "latest.txt", "log.txt", "step_00000002"]
    assert os.listdir(tmp_path / "rank1") == ["log.txt.rank1"]
    assert "copypaste:" in outs[0]
