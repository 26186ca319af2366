from .logger import log_every_n_seconds, setup_logger
from .misc import (
    MetricLogger,
    SmoothedValue,
    check_path,
    collect_env_info,
    deterministic,
    get_sha,
    seed_all_rng,
)

__all__ = ["MetricLogger", "SmoothedValue", "check_path", "collect_env_info",
           "deterministic", "get_sha", "log_every_n_seconds", "seed_all_rng",
           "setup_logger"]
