"""The port's profiler ranges (CPU, tiny configs): ``predict``'s
``nmrf::predict`` tree, the model's stage ranges that hold every op of its
forward, the training step's ``nmrf::step``, and what they leave alone: the
disparity, bit for bit, and the exported artifact's graph.

A forward op that records an autograd sequence number lies in exactly one
stage range; that is what lets a trace put each backward node down to the
stage that made it (``benchmark/spans.py``)."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nmrf_tpu_torch import (build_criterion, build_model, build_optimizer,
                            get_cfg, make_train_step, predict)
from nmrf_tpu_torch.data import synthetic_batch
from nmrf_tpu_torch.utils.export import export_eval

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["DPN.MAX_DISP", "64", "SOLVER.MAX_DISP", "48",
         "NMP.NUM_PROP_LAYERS", "2", "NMP.NUM_INFER_LAYERS", "2",
         "NMP.NUM_REFINE_LAYERS", "2", "SOLVER.LOSS_WEIGHTS",
         "[1.0, 1.2, 1.4, 2.0]"]
PHASES = ["nmrf::predict.prep", "nmrf::predict.copy_in",
          "nmrf::predict.forward", "nmrf::predict.wait",
          "nmrf::predict.copy_out"]
STAGES = ["nmrf::backbone", "nmrf::cost_volume", "nmrf::dpn",
          "nmrf::inference", "nmrf::refinement"]
OLD = ["nmrf::forward", "nmrf::loss", "nmrf::backward", "nmrf::optimizer"]
VARIANTS = ["resnet", "swin"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (the suite runs a test process per core or so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def config(variant):
    cfg = get_cfg()
    if variant == "swin":
        cfg.merge_from_file(str(ROOT / "configs" / "sceneflow_swint.yaml"))
    cfg.merge_from_list(SMALL)
    cfg.freeze()
    return cfg


def model_of(variant, train=False):
    torch.manual_seed(0)
    model = build_model(config(variant), device="cpu")
    return model.train() if train else model.eval()


def frames(h=60, w=124, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(2)]


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.events())


def spans(events, names):
    """(start, end, name) of the ranges named in ``names``, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.name in names)


def inside(span, outer):
    return outer[0] <= span[0] and span[1] <= outer[1]


@pytest.mark.parametrize("variant", VARIANTS)
def test_predict_tree(variant):
    model = model_of(variant)
    _, events = traced(lambda: predict(model, *frames()))
    (whole,) = spans(events, {"nmrf::predict"})
    phases = spans(events, set(PHASES))
    assert [p[2] for p in phases] == PHASES
    assert all(inside(p, whole) for p in phases)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))
    stages = spans(events, set(STAGES))
    assert [s[2] for s in stages] == STAGES
    forward = phases[PHASES.index("nmrf::predict.forward")]
    assert all(inside(s, forward) for s in stages)


@pytest.mark.parametrize("variant", VARIANTS)
def test_predict_bits_unchanged_by_tracing(variant):
    model = model_of(variant)
    a, b = frames(seed=1)
    plain = predict(model, a, b)
    traced_disp, _ = traced(lambda: predict(model, a, b))
    assert plain.dtype == np.float32 and plain.shape == a.shape[:2]
    assert np.array_equal(plain, traced_disp)


@pytest.mark.parametrize("variant", VARIANTS)
def test_step_ranges_hold_every_forward_op(variant):
    cfg = config(variant)
    model = model_of(variant, train=True)
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           grad_clip=cfg.SOLVER.GRAD_CLIP)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(1, 64, 128, max_disp=48).items()}
    losses, events = traced(lambda: step(batch))
    assert torch.isfinite(losses["total"])
    (whole,) = spans(events, {"nmrf::step"})
    old = spans(events, set(OLD))
    assert [s[2] for s in old] == OLD
    assert all(inside(s, whole) for s in old)
    forward, loss = old[0], old[1]
    stages = spans(events, set(STAGES))
    assert [s[2] for s in stages] == STAGES
    assert all(inside(s, forward) for s in stages)
    seq = [e for e in events if e.sequence_nr >= 0
           and not e.name.startswith("autograd::engine")
           and (inside((e.time_range.start, e.time_range.end), forward)
                or inside((e.time_range.start, e.time_range.end), loss))]
    assert len(seq) > 100
    for e in seq:
        t = (e.time_range.start, e.time_range.end)
        holders = [s[2] for s in stages if inside(t, s)]
        if inside(t, loss):
            assert holders == [], e.name
        else:
            assert len(holders) == 1, (e.name, holders)


def test_export_graph_has_no_profiler_op():
    model = model_of("resnet")
    exported = export_eval(model, (1, 32, 64, 3))
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    assert targets
    assert not [t for t in targets
                if "profiler" in t or "record_function" in t]
