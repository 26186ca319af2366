"""Cells as data: a throwaway configuration, traffic mixes, cells, limits
and a metric, written as files into a temporary root, run with
``--device cpu`` at a tiny size with no code edit.  The rehearsal reads
only program counters, so no device metric name carries a CPU number;
the real path refuses to run without a card."""

import json

import pytest
import torch

from benchmark import harness, run
from benchmark.tests import tiny

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("root"))


def rehearse(root, cell, trace, capsys):
    result = run.main(["--workload", cell, "--seed", str(2 ** 31 + 9),
                       "--seconds", "0.5", "--trace", str(trace), "--device",
                       "cpu", "--root", str(root)], start=0.0)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    return result, err


@pytest.mark.parametrize("cell", ["tiny_stream", "tiny_train",
                                  "tiny_swin_train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_throwaway_cell_runs_from_files(root, cell, trace, capsys):
    result, err = rehearse(root, cell, trace, capsys)
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "checks"
    limits = json.loads((root / "benchmark" / "limits" / f"{cell}.json")
                        .read_text())
    assert set(result["checks"]) == set(limits)
    last = err.strip().splitlines()[-len(limits):]
    assert all(line.startswith("check ") for line in last)
    # only the program counter: no end-to-end or device metric off the card
    expected = {"completed_test"} if trace else set()
    assert set(result["metrics"]) == expected


RANKS = '''"""A generator of its own: the launcher of a cell that runs ranks."""


class Generator:
    def __init__(self, cell, seed, device, trace=False):
        self.p = cell.traffic

    def setup(self):
        pass

    def measure(self, seconds):
        return {"window_s": seconds, "attempted": 3, "failed": 0,
                "memory_peak_bytes": self.p["peak"]}

    def check(self):
        return {"answer_gap": 0.0}
'''


def test_a_generator_of_its_own_runs_from_files(tmp_path, capsys):
    """A cell whose traffic names a new generator file (as a cell on four
    cards, launching its ranks, would) runs with no code edit and gives
    its own fullest card's peak."""
    root = tiny.write(tmp_path)
    b = root / "benchmark"
    (b / "traffic" / "tiny_ranks.py").write_text(RANKS)
    (b / "traffic" / "tiny_ranks.json").write_text(json.dumps(
        {"generator": "tiny_ranks", "peak": 12345}))
    (b / "limits" / "tiny_ranks.json").write_text('{"answer_gap": 0}')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny_ranks", "config": "tiny_resnet",
                               "traffic": "tiny_ranks", "chips": 4,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = rehearse(root, "tiny_ranks", 0, capsys)
    assert result["correct"] is True and result["attempted"] == 3
    assert result["device"]["memory_peak_bytes"] == 12345
    assert result["device"]["count"] == 4


def test_cell_files_are_found_by_name(root):
    cell = harness.Cell(root, "tiny_train")
    assert cell.traffic["generator"] == "train_steps"
    assert cell.spec("training")["NMP.NUM_INFER_LAYERS"] == 2
    assert [m["name"] for m in cell.metrics("per_layer")][-1] == \
        "completed_test"
    names = [m["name"] for m in cell.metrics("end_to_end")]
    assert "serve_p95_ms" not in names


def test_the_real_path_needs_a_card(root, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "tiny_stream", "--seed", "1", "--seconds",
                  "1", "--root", str(root)])
    assert exc.value.code == 2
    assert capsys.readouterr().out == ""


def test_every_repository_cell_has_its_files():
    for w in json.loads((tiny.ROOT / "BENCHMARK.json").read_text())[
            "workloads"]:
        cell = harness.Cell(tiny.ROOT, w["name"])
        assert cell.limits, w["name"]
        cell.module("traffic", cell.traffic["generator"])
        for kind in ("end_to_end", "per_layer"):
            for m in cell.metrics(kind):
                assert callable(cell.module("metrics", m["name"]).read)


@pytest.mark.gpu
def test_rehearsal_cell_on_the_card(root, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = run.main(["--workload", "tiny_stream", "--seed", "3",
                       "--seconds", "1", "--trace", "1", "--root", str(root)])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert "idle_share.serve" in result["metrics"]
