from .optimizer import build_optimizer, build_scheduler, param_group
from .step import make_train_step

__all__ = ["build_optimizer", "build_scheduler", "make_train_step",
           "param_group"]
