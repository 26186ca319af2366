from .optimizer import build_optimizer, param_group
from .step import make_train_step

__all__ = ["build_optimizer", "make_train_step", "param_group"]
