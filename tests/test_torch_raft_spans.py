"""RAFT-Stereo's profiler ranges (CPU, 64x128, 3 iterations): every op of
the forward lies in exactly one of ``nmrf::raft.encode``, ``.corr``,
``.update`` and ``.upsample``, the lookups in ``nmrf::raft.lookup``
inside ``.update``, one an iteration; the model counts the iterations it
ran, and ``predict`` leaves the count readable."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nmrf_tpu_torch import get_cfg, predict
from nmrf_tpu_torch.models import build_model

ITERS = 3
TOP = ["nmrf::raft.encode", "nmrf::raft.corr", "nmrf::raft.update",
       "nmrf::raft.upsample"]
LOOKUP = "nmrf::raft.lookup"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.ARCH", "raft_stereo", "RAFT.VALID_ITERS",
                         ITERS])
    return build_model(cfg, device="cpu")


def spans(events, names):
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.name in names)


def inside(t, span):
    return span[0] <= t[0] and t[1] <= span[1]


def test_every_forward_op_in_one_range(model):
    x = torch.rand(1, 64, 128, 3) * 255.0
    y = x.flip(2)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x, y)
    events = list(prof.events())
    top = spans(events, set(TOP))
    assert [s[2] for s in top] == TOP
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    lookups = spans(events, {LOOKUP})
    assert len(lookups) == ITERS
    assert all(inside(s, top[2]) for s in lookups)
    ops = [e for e in events if e.name.startswith("aten::")]
    assert len(ops) > 200
    for e in ops:
        t = (e.time_range.start, e.time_range.end)
        holders = [s[2] for s in top if inside(t, s)]
        assert len(holders) == 1, (e.name, holders)
    assert model.iterations == ITERS


def test_predict_leaves_the_count(model):
    rng = np.random.RandomState(0)
    a, b = (rng.randint(0, 256, (60, 124, 3)).astype(np.uint8)
            for _ in range(2))
    model.iterations = 0
    disp = predict(model, a, b)
    assert disp.shape == (60, 124) and np.isfinite(disp).all()
    assert model.iterations == ITERS
