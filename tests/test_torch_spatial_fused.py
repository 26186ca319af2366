"""The port's H-sharded training step with ``NMRF_FUSED_POS=1`` against the
JAX package's (CPU, float32, gloo).

The 1 x 2 grid of ``tests/test_torch_spatial.py`` (96x64, batch 2, 2
layers per stage, the same weights through ``params_from_jax`` and the same
batch) takes one training step with the flag set on both sides: the port's
window layers differentiate through B7's plain version (the function of
the fused backward kernel, on the tile's row0/hp_total), the JAX package's
through ``window_attention_pos_op`` (the Pallas B7 in interpret mode).
Losses |d| < 1e-4 and every gradient leaf at the tolerances of
``tests/test_torch_spatial.py`` (``check_train_step``).

JAX reads ``NMRF_FUSED_POS`` when it traces, so the test sets it with
``monkeypatch.setenv`` before it builds and jits the step; the port's
processes inherit it.
"""

import numpy as np
import torch

from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu.ops.pallas import attention as fa
from nmrf_tpu_torch.parallel import spawn
from nmrf_tpu_torch.utils.convert import params_from_jax

from . import test_torch_spatial_workers as W
from .test_torch_spatial import (_jax_cfg, check_train_step, jax_sharded_step,
                                 jax_weights_and_batch)


def test_fused_pos_sharded_step_matches_jax_sharded(monkeypatch, tmp_path):
    monkeypatch.setenv("NMRF_FUSED_POS", "1")
    jax_calls = []
    jax_op = fa.window_attention_pos_op

    def counted(*args, **kw):
        jax_calls.append(1)
        return jax_op(*args, **kw)

    monkeypatch.setattr(fa, "window_attention_pos_op", counted)
    cfg = _jax_cfg()
    params, batch = jax_weights_and_batch(build_model_jax(cfg)[0])
    want_losses, want_grads = jax_sharded_step(cfg, params, batch)
    # every one of the 2 + 2 window layers traced through the fused op
    # (shard_map traces its body more than once)
    assert len(jax_calls) >= 4

    torch.save(params_from_jax(params), tmp_path / "weights.pt")
    np.savez(tmp_path / "batch.npz", **batch)
    spawn(W.fused_step_worker, 2, "gloo", args=(str(tmp_path), str(tmp_path)),
          timeout_s=180)
    ranks = [torch.load(tmp_path / f"fused_{r}.pt") for r in range(2)]
    for rank in ranks:  # every window layer's backward went through B7's function
        assert rank["calls"] == {"window_attention_pos_bwd_plain": 4}
    check_train_step(ranks, want_losses, want_grads)
