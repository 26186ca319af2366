"""Logging setup, the port's copy of ``nmrf_tpu/utils/logger.py`` (reference
``nmrf/utils/logger.py:33-141``): colored
rank-0 console + per-rank log files, cached streams, throttled
``log_every_n_seconds``.
"""

import atexit
import functools
import logging
import os
import sys
import time
from collections import Counter


class _ColorfulFormatter(logging.Formatter):
    GREY = "\x1b[38;20m"
    YELLOW = "\x1b[33;20m"
    RED = "\x1b[31;20m"
    RESET = "\x1b[0m"

    def format(self, record):
        log = super().format(record)
        if record.levelno == logging.WARNING:
            return self.YELLOW + log + self.RESET
        if record.levelno >= logging.ERROR:
            return self.RED + log + self.RESET
        return log


def setup_logger(output=None, distributed_rank=0, *, color=True,
                 name="nmrf_tpu_torch", abbrev_name=None):
    """Initialize the framework logger (rank-0 console + per-rank files).
    A later call replaces the handlers of an earlier one, so a process that
    runs the CLI several times (``train.main``) logs each line once."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for handler in list(logger.handlers):
        logger.removeHandler(handler)

    fmt = "[%(asctime)s] %(name)s %(levelname)s: %(message)s"
    datefmt = "%m/%d %H:%M:%S"

    if distributed_rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        formatter = (_ColorfulFormatter(fmt, datefmt=datefmt) if color
                     else logging.Formatter(fmt, datefmt=datefmt))
        ch.setFormatter(formatter)
        logger.addHandler(ch)

    if output is not None:
        filename = (output if output.endswith(".txt") or output.endswith(".log")
                    else os.path.join(output, "log.txt"))
        if distributed_rank > 0:
            filename = filename + f".rank{distributed_rank}"
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.StreamHandler(_cached_log_stream(filename))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt, datefmt=datefmt))
        logger.addHandler(fh)

    return logger


@functools.lru_cache(maxsize=None)
def _cached_log_stream(filename):
    io = open(filename, "a", buffering=1024)
    atexit.register(io.close)
    return io


_LOG_COUNTER = Counter()
_LOG_TIMER = {}


def log_every_n_seconds(lvl, msg, n=1, *, name="nmrf_tpu_torch"):
    """Log no more than once per n seconds per call site
    (reference logger.py:126-141)."""
    caller_frame = sys._getframe(1)
    key = (caller_frame.f_code.co_filename, caller_frame.f_lineno)
    last_logged = _LOG_TIMER.get(key, None)
    current_time = time.time()
    if last_logged is None or current_time - last_logged >= n:
        logging.getLogger(name).log(lvl, msg)
        _LOG_TIMER[key] = current_time
