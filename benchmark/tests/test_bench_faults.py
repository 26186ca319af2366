"""The output check fails what it should: a whole rehearsal run (no look
for a card) with the timed path broken underneath comes out not
``correct``, once for each fault a cell can have, and so does the
control, the float8 reference in the program's place."""

import pytest
import torch

from benchmark import harness, run
from benchmark.tests import tiny

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("root"))


def rehearse(root, cell):
    return run.main(["--workload", cell, "--seed", "77", "--seconds", "0.3",
                     "--device", "cpu", "--root", str(root)], start=0.0)


def test_sound_runs_are_correct(root):
    assert rehearse(root, "tiny_stream")["correct"]
    assert rehearse(root, "tiny_train")["correct"]


def test_an_answer_altered_where_it_is_produced(root, monkeypatch):
    from nmrf_tpu_torch.models import nmrf

    forward = nmrf.NMRF.forward

    def altered(self, *args):
        out = forward(self, *args)
        out["disp"] = out["disp"] + 1.0
        return out

    monkeypatch.setattr(nmrf.NMRF, "forward", altered)
    result = rehearse(root, "tiny_stream")
    assert not result["correct"]
    assert result["checks"]["epe_px"]["value"] > 0.9


def test_an_inference_head_altered_where_it_is_produced(root, monkeypatch):
    from nmrf_tpu_torch.models import nmrf

    init = nmrf.NMRF.__init__

    def altered(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.infer_head.register_forward_hook(lambda m, a, o: o * 1.5)

    monkeypatch.setattr(nmrf.NMRF, "__init__", altered)
    result = rehearse(root, "tiny_stream")
    assert not result["correct"]
    assert result["checks"]["heads_rel"]["value"] > 0.1


def broken_step(monkeypatch, wrap):
    import nmrf_tpu_torch.solver as solver

    make = solver.make_train_step

    def make_broken(model, *args, **kwargs):
        return wrap(model, make(model, *args, **kwargs))

    monkeypatch.setattr(solver, "make_train_step", make_broken)


def test_a_step_that_leaves_the_state_unchanged(root, monkeypatch):
    def unchanged(model, step):
        def run_step(batch):
            before = [p.detach().clone() for p in model.parameters()]
            out = step(batch)
            with torch.no_grad():
                for p, b in zip(model.parameters(), before):
                    p.copy_(b)
            return out
        return run_step

    broken_step(monkeypatch, unchanged)
    result = rehearse(root, "tiny_train")
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(root, monkeypatch):
    def half(model, step):
        def run_step(batch):
            return step({k: v[:v.shape[0] // 2] for k, v in batch.items()})
        return run_step

    broken_step(monkeypatch, half)
    result = rehearse(root, "tiny_train")
    assert not result["correct"]
    assert result["checks"]["loss_rel"]["value"] > 1e-2


@pytest.mark.parametrize("cell", ["tiny_stream", "tiny_train",
                                  "tiny_swin_train"])
def test_the_control_is_not_correct(root, cell):
    c = harness.Cell(root, cell)
    generator = c.module("traffic", c.traffic["generator"]).Generator(
        c, 31, torch.device("cpu"))
    generator.inputs()
    correct, checks = harness.judge(generator.control(), c.limits)
    assert not correct
    assert max(v["value"] / v["limit"] for v in checks.values()) > 10
