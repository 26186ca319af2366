"""PyTorch/CUDA port of NMRF (the JAX package ``nmrf_tpu`` is its reference).

Entry points: ``build_model(cfg, device=None)`` and
``predict(model, img1, img2)`` for inference; ``build_criterion(cfg)``,
``build_optimizer(model, cfg)`` and ``make_train_step(model, criterion,
optimizer, scheduler, accum_steps, grad_clip=...)`` for training.  They run on CUDA unless
the caller passes ``device="cpu"`` to ``build_model``.  The H-sharded
(spatial-parallel) path over ``torch.distributed``: ``parallel.make_mesh``,
then ``build_model(cfg, mesh=)``, ``parallel.make_sharded_forward`` and
``make_train_step(..., mesh=)``.  Training and evaluation from a dataset,
with checkpoints: ``python -m nmrf_tpu_torch.train`` (``train.main``).
Serving: the demo and KITTI-submission CLI ``python -m
nmrf_tpu_torch.inference``, the exported artifact
(``utils.export.export_eval``, ``python -m
nmrf_tpu_torch.tools.export_serving``) and its HTTP server (``python -m
nmrf_tpu_torch.tools.serve_http``).
"""

from .config import get_cfg
from .inference import predict
from .models import build_criterion, build_model
from .solver import build_optimizer, make_train_step

__all__ = ["build_criterion", "build_model", "build_optimizer", "get_cfg",
           "make_train_step", "predict"]
