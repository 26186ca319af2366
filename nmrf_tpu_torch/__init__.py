"""PyTorch/CUDA port of NMRF (the JAX package ``nmrf_tpu`` is its reference).

Entry points: ``build_model(cfg, device=None)`` and
``predict(model, img1, img2)``; both run on CUDA unless the caller passes
``device="cpu"`` to ``build_model``.
"""

from .config import get_cfg
from .inference import predict
from .models import build_model

__all__ = ["build_model", "get_cfg", "predict"]
