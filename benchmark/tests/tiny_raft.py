"""A throwaway benchmark root for RAFT-Stereo at a size the CPU holds:
``tiny.write``'s root with the ``raft_stereo`` configuration at 4
iterations, a tiny ``serve_stream_raft`` traffic mix and its cell
``tiny_raft_stream``, all as files only."""

import json

from benchmark.tests import tiny

ITERS = 4
# the first two requests compared: a window that completes two checks both
SERVE = dict(tiny.SERVE, generator="serve_stream_raft", sample_within=2)
# float32 on both sides: round-off is all the program's runs read
LIMITS = {"fmap_rel": 1e-4, "corr_rel": 1e-4, "hidden_rel": 1e-4,
          "disp_lowres_px": 1e-3, "epe_px": 1e-3}


def write(tmp, precision="float32"):
    """``tiny.write(tmp, precision)`` plus the configuration
    ``tiny_raft`` and the cell ``tiny_raft_stream``; returns the root."""
    root = tiny.write(tmp, precision)
    b = root / "benchmark"
    conf = json.loads((tiny.ROOT / "benchmark" / "configs" / "raft_stereo.json")
                      .read_text())
    conf["model"]["RAFT.VALID_ITERS"] = ITERS
    conf["precision"] = {"TPU.COMPUTE_DTYPE": precision}
    (b / "configs" / "tiny_raft.json").write_text(json.dumps(conf))
    (b / "traffic" / "tiny_raft_stream.json").write_text(json.dumps(SERVE))
    (b / "limits" / "tiny_raft_stream.json").write_text(json.dumps(LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_raft", "source": "test",
                             "file": "benchmark/configs/tiny_raft.json",
                             "reduced": ["RAFT.VALID_ITERS"], "why": "test"})
    bench["workloads"].append({"name": "tiny_raft_stream",
                               "config": "tiny_raft",
                               "traffic": "tiny_raft_stream", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
