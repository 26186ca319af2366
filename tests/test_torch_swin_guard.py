"""The tap-path guard of the swin training step (CPU, float32), as
``tests/test_tap_guard.py`` drives the JAX package's: the step's
``msda_tap_oob`` metric -> its interval max between readbacks ->
``TapOOBGuard``'s warning and fallback -> the exact gather path.

The model, weights, batch and drop-path masks are those of
``tests/test_torch_swin_train.py``, at lr 0 so that the weights stay.
After the fallback the port's step is held against the JAX step built with
``msda_tap_radius=0`` (``TPU.MSDA_TAP_RADIUS 0``, the exact gather path) on
the same weights, at that file's tolerances.
"""

import logging

import numpy as np
import pytest

from nmrf_tpu_torch import get_cfg
from nmrf_tpu_torch.models.adaptor import MSDeformAttn
from nmrf_tpu_torch.utils.guards import TapOOBGuard
from .test_torch_swin_train import (BATCH_SEED, MASK_SEED, KeepMasks,  # noqa: F401
                                    assert_step_matches, dithered_batch,
                                    few_threads, jax_swin_step, port_grads,
                                    port_step, port_swin_model, push_offsets,
                                    swin_cfg, swin_params)


@pytest.fixture(scope="module")
def setup():
    return swin_params(), dithered_batch(BATCH_SEED), KeepMasks(MASK_SEED)


def test_guard_warn_and_fallback_decision(caplog):
    g = TapOOBGuard(thresh=1e-3, fallback=False)
    with caplog.at_level(logging.WARNING, logger="nmrf_tpu_torch.utils.guards"):
        assert g.check(0.0) is False
        assert g.check(5e-4) is False
        assert caplog.records == []
        assert g.check(0.02) is False  # warns, but no fallback configured
    assert any("DROPPED" in r.getMessage() for r in caplog.records)
    g2 = TapOOBGuard(thresh=1e-3, fallback=True)
    assert g2.check(0.02) is True   # the fallback, exactly once
    assert g2.check(0.5) is False
    g3 = TapOOBGuard(thresh=-1, fallback=True)
    assert not g3.enabled and g3.check(1.0) is False
    cfg = get_cfg()
    cfg.TPU.MSDA_OOB_FALLBACK = True
    g4 = TapOOBGuard.from_cfg(cfg)
    assert (g4.thresh, g4.fallback) == (cfg.TPU.MSDA_OOB_THRESH, True)


def test_interval_max_holds_across_steps(setup):
    """A spike at a step between readbacks survives to the next readback:
    the step reports max(this step, the interval so far) as a device
    scalar, and ``read_oob`` returns it and starts a new interval."""
    params, batch, masks = setup
    model = port_swin_model(params)
    step = port_step(model, swin_cfg(get_cfg()), masks)
    bias = {id(m): m.sampling_offsets.bias.detach().clone()
            for m in model.modules() if isinstance(m, MSDeformAttn)}
    pushed = port_swin_model(push_offsets(params, 50.0)).state_dict()

    def set_offsets(push):
        for name, m in model.named_modules():
            if isinstance(m, MSDeformAttn):
                m.sampling_offsets.bias.data.copy_(
                    pushed[f"{name}.sampling_offsets.bias"] if push
                    else bias[id(m)])

    assert float(step(batch)["msda_tap_oob"]) == 0.0
    set_offsets(True)
    spike = float(step(batch)["msda_tap_oob"])
    set_offsets(False)
    assert spike > 0.9
    assert float(step(batch)["msda_tap_oob"]) == spike  # the interval max
    assert step.read_oob() == spike
    assert float(step(batch)["msda_tap_oob"]) == 0.0  # a new interval
    assert step.read_oob() == 0.0
    assert step.read_oob() is None  # no step since the last readback


def test_fallback_fires_once_and_matches_the_jax_exact_path(setup, caplog):
    """Offsets pushed 3 level pixels out: the guard warns and, with the
    fallback on, fires once; every MSDeformAttn then takes the exact gather
    path (tap radius 0) on the same parameter objects, the step stops
    reporting the metric, and its losses and gradients equal the JAX step
    built with ``msda_tap_radius=0`` on the same weights."""
    params, batch, masks = setup
    pushed = push_offsets(params, 3.0)
    model = port_swin_model(pushed)
    step = port_step(model, swin_cfg(get_cfg()), masks)
    before = [p for p in model.parameters()]
    guard = TapOOBGuard(thresh=1e-3, fallback=True)
    oob = float(step(batch)["msda_tap_oob"])
    assert oob > 1e-3
    with caplog.at_level(logging.WARNING, logger="nmrf_tpu_torch.utils.guards"):
        assert step.read_oob(guard) == oob
    assert guard.fired and any("Falling back" in r.getMessage()
                               for r in caplog.records)
    attns = [m for m in model.modules() if isinstance(m, MSDeformAttn)]
    assert len(attns) == 4 and all(m.tap_radius == 0 for m in attns)
    assert "msda_tap_oob" not in step(batch)
    assert step.read_oob(guard) is None and guard.check(1.0) is False
    assert all(a is b for a, b in zip(model.parameters(), before))

    want = jax_swin_step(pushed, batch, masks, radius=0)
    assert want["oob"] is None  # the exact path sows no metric
    assert_step_matches(port_grads(model, batch, masks), want)
    assert np.isfinite(want["losses"]["total"])
