"""A throwaway benchmark root at a size the CPU holds: the repository's
``BENCHMARK.json`` with a tiny configuration, tiny traffic mixes and cells
of its own, their limits and one more metric, all as files only."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {"NMP.NUM_PROP_LAYERS": 2, "NMP.NUM_INFER_LAYERS": 2,
              "NMP.NUM_REFINE_LAYERS": 2, "SOLVER.LOSS_WEIGHTS": [1.0] * 4}
SERVE = {"generator": "serve_stream", "height": 60, "width": 124, "pool": 3,
         "max_disp": 48, "warmup": 1, "sample": 2, "sample_within": 3,
         "trace_requests": 1}
TRAIN = {"generator": "train_steps", "height": 64, "width": 128, "batch": 2,
         "pool": 4, "max_disp": 48, "checked_steps": 3, "trace_steps": 1}
# float32 on both sides: round-off, amplified where an argmax or a median
# flips, is all the program's runs read
LIMITS = {"serve": {"epe_px": 0.5, "prob_l1": 1e-3, "heads_rel": 1e-3},
          "train": {"loss_rel": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-2}}
COUNTER = '''"""Requests or steps completed in the window."""


def read(rec):
    return rec["attempted"]
'''


def write(tmp, precision="float32"):
    """Write the root into ``tmp``; returns it.  Cells: ``tiny_stream``,
    ``tiny_train`` (resnet) and ``tiny_swin_train``."""
    tmp = Path(tmp)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (b / sub).mkdir(parents=True, exist_ok=True)
    for name, base in (("tiny_resnet", "nmrf_resnet"),
                       ("tiny_swint", "nmrf_swint")):
        conf = json.loads((ROOT / "benchmark" / "configs" / f"{base}.json")
                          .read_text())
        conf["model"].update({k: v for k, v in TINY_MODEL.items()
                              if k.startswith("NMP")})
        conf["solver"]["SOLVER.LOSS_WEIGHTS"] = TINY_MODEL[
            "SOLVER.LOSS_WEIGHTS"]
        conf["precision"] = {"TPU.COMPUTE_DTYPE": precision}
        (b / "configs" / f"{name}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": list(TINY_MODEL), "why": "test"})
    (b / "traffic" / "tiny_stream.json").write_text(json.dumps(SERVE))
    (b / "traffic" / "tiny_train.json").write_text(json.dumps(TRAIN))
    cells = (("tiny_stream", "tiny_resnet", "tiny_stream", "serve"),
             ("tiny_train", "tiny_resnet", "tiny_train", "train"),
             ("tiny_swin_train", "tiny_swint", "tiny_train", "train"))
    for cell, conf, traffic, kind in cells:
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        (b / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS[kind]))
    bench["per_layer"].append({"name": "completed_test", "unit": "count",
                               "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "setup_s"})
    (b / "metrics" / "completed_test.py").write_text(COUNTER)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
