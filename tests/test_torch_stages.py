"""PyTorch port NMP stages against the JAX package (CPU): Inference and
Refinement with 2 layers (both shift parities) on grids that need window
padding, against the flax stage on its Pallas path (interpret mode) and its
XLA path.  Tolerance: float32, atol = rtol = 1e-4."""

import numpy as np
import jax
import pytest

from nmrf_tpu.models import stages as stages_jax
from nmrf_tpu_torch.models import stages

from .test_torch_modules import TOL, _load, _port, _rand


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("stage", ["inference", "refinement"])
def test_stage_with_window_padding(stage, use_pallas):
    """Inference/Refinement stage, 2 layers (both shift parities), on a grid
    that needs centered window padding (8 x 10 -> 12 x 12 at ws 6 for
    Inference, 7 x 10 -> 8 x 12 at ws 4 for Refinement)."""
    rng = np.random.RandomState(4)
    if stage == "inference":
        H, W, N, ws = 8, 10, 4, 6
        labels = rng.uniform(0, 6, (1, H, W, N)).astype(np.float32)
    else:
        H, W, N, ws = 7, 10, 1, 4
        labels = rng.uniform(0, 6, (1, H, W)).astype(np.float32)
    fmaps = [_rand(rng, 1, H, W, 8), _rand(rng, 1, H, W, 8),
             _rand(rng, 1, H, W, 16), _rand(rng, 1, H, W, 16)]
    cls_jax = stages_jax.Inference if stage == "inference" else stages_jax.Refinement
    jm = cls_jax(cost_group=4, dim=16, num_layers=2, mlp_ratio=2.0,
                 window_size=ws, n_heads=2, normalize_before=True,
                 use_pallas=use_pallas)
    params = jm.init(jax.random.PRNGKey(0), labels, *fmaps)
    cls = stages.Inference if stage == "inference" else stages.Refinement
    pm = cls(8, 4, 16, 2, 2.0, ws, 2, normalize_before=True, use_kernels=True)
    params = _load(pm, params)
    want = np.asarray(jm.apply(params, labels, *fmaps))
    np.testing.assert_allclose(_port(pm, labels, *fmaps), want, **TOL)
