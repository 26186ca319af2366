"""Training observability + misc helpers, the port's copy of
``nmrf_tpu/utils/misc.py`` (reference ``nmrf/utils/misc.py``): SmoothedValue /
MetricLogger windowed stats with iter/data timing, deterministic seeding
(``seed_all_rng``), env/provenance capture (``collect_env_info``/``get_sha``).
The reference's ``datetime.now()`` crash on SEED<0 (SURVEY.md §2.9.4) is fixed.
"""

import contextlib
import datetime
import logging
import os
import random
import subprocess
import time
from collections import defaultdict, deque

import numpy as np


class SmoothedValue:
    """Track a series and provide windowed median/avg + global avg
    (reference misc.py:87-150)."""

    def __init__(self, window_size=20, fmt=None):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value, n=1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Iteration logger with data/iter timing (reference misc.py:151-244)."""

    def __init__(self, delimiter="\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = float(v)
            assert isinstance(v, (float, int)), (k, type(v))
            self.meters[k].update(v)

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq, header="", logger=None, total=None):
        logger = logger or logging.getLogger("nmrf_tpu_torch")
        i = 0
        total = total if total is not None else _safe_len(iterable)
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                eta = ""
                if total:
                    eta_seconds = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_seconds))}  "
                logger.info(
                    f"{header} [{i}{f'/{total}' if total else ''}]  {eta}"
                    f"{self}  time: {iter_time}  data: {data_time}")
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        logger.info(f"{header} Total time: {datetime.timedelta(seconds=int(total_time))}")


def _safe_len(it):
    try:
        return len(it)
    except TypeError:
        return None


def seed_all_rng(seed=None):
    """Seed numpy/random/PYTHONHASHSEED (reference misc.py:362-380; the
    datetime-crash on random-seed path is fixed).  Returns the seed used.
    The port's model weights and drop-path masks come from generators of
    their own, seeded from ``cfg.SEED`` (``models.build_model``); this seeds
    the host generators the data augmentation draws from."""
    if seed is None:
        seed = (os.getpid()
                + int(datetime.datetime.now().strftime("%S%f"))
                + int.from_bytes(os.urandom(2), "big"))
        logging.getLogger("nmrf_tpu_torch").info(
            "Using a generated random seed {}".format(seed))
    seed = int(seed) % (2 ** 31)
    np.random.seed(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def get_sha():
    """Git provenance (reference misc.py:67-84)."""
    cwd = os.path.dirname(os.path.abspath(__file__))

    def _run(command):
        return subprocess.check_output(command, cwd=cwd).decode("ascii").strip()

    sha, diff, branch = "N/A", "clean", "N/A"
    try:
        sha = _run(["git", "rev-parse", "HEAD"])
        subprocess.check_output(["git", "diff"], cwd=cwd)
        diff = _run(["git", "diff-index", "HEAD"])
        diff = "has uncommitted changes" if diff else "clean"
        branch = _run(["git", "rev-parse", "--abbrev-ref", "HEAD"])
    except Exception:
        pass
    return f"sha: {sha}, status: {diff}, branch: {branch}"


def collect_env_info():
    """Environment dump (reference misc.py:280-360, PyTorch edition): the
    interpreter, numpy, torch and its CUDA, and the cards."""
    import sys

    import torch

    lines = [f"Python: {sys.version.replace(chr(10), ' ')}",
             f"numpy: {np.__version__}",
             f"torch: {torch.__version__}, CUDA: {torch.version.cuda}"]
    if torch.cuda.is_available():
        lines.append("devices: " + ", ".join(
            torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())))
    else:
        lines.append("devices: no CUDA device")
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        lines.append(f"rank: {torch.distributed.get_rank()}/"
                     f"{torch.distributed.get_world_size()}")
    return "\n".join(lines)


def check_path(path):
    if not os.path.exists(path):
        os.makedirs(path, exist_ok=True)


@contextlib.contextmanager
def deterministic(on=True):
    """Inside the block, the card gives the same bits for the same inputs
    on every run: ``torch.use_deterministic_algorithms`` (the sorted
    formulations of ``gather``'s backward and ``scatter_add_``, or an error
    for an op that has none), cuDNN's deterministic convolution algorithms
    and cuBLAS's fixed workspace (``CUBLAS_WORKSPACE_CONFIG=:4096:8``).  The
    hand-written kernels are deterministic either way.  The settings before
    the block come back after it; the environment variable stays set."""
    import torch

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    if on:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            before[1:]
