"""A throwaway benchmark root for IGEV-Stereo at a size the CPU holds:
``tiny.write``'s root with the ``igev_stereo`` configuration at 4
iterations, a tiny ``serve_stream_igev`` traffic mix and its cell
``tiny_igev_stream``, all as files only."""

import json

from benchmark.tests import tiny

ITERS = 4
# the first two requests compared: a window that completes two checks both
SERVE = dict(tiny.SERVE, generator="serve_stream_igev", sample_within=2)
# float32 on both sides: round-off is all the program's runs read (the
# volume stage's 16 3-D convolutions in a row, the starting disparity's
# expectation over 48 disparities)
LIMITS = {"match_rel": 1e-4, "geo_rel": 1e-3, "init_disp_px": 1e-3,
          "hidden_rel": 1e-4, "disp_lowres_px": 1e-3, "epe_px": 1e-3}


def write(tmp, precision="float32"):
    """``tiny.write(tmp, precision)`` plus the configuration
    ``tiny_igev`` and the cell ``tiny_igev_stream``; returns the root."""
    root = tiny.write(tmp, precision)
    b = root / "benchmark"
    conf = json.loads((tiny.ROOT / "benchmark" / "configs"
                       / "igev_stereo.json").read_text())
    conf["model"]["RAFT.VALID_ITERS"] = ITERS
    conf["precision"] = {"TPU.COMPUTE_DTYPE": precision}
    (b / "configs" / "tiny_igev.json").write_text(json.dumps(conf))
    (b / "traffic" / "tiny_igev_stream.json").write_text(json.dumps(SERVE))
    (b / "limits" / "tiny_igev_stream.json").write_text(json.dumps(LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_igev", "source": "test",
                             "file": "benchmark/configs/tiny_igev.json",
                             "reduced": ["RAFT.VALID_ITERS"], "why": "test"})
    bench["workloads"].append({"name": "tiny_igev_stream",
                               "config": "tiny_igev",
                               "traffic": "tiny_igev_stream", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
