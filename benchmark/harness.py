"""What every run shares: finding a cell's files by name, the device check,
the measured package's configuration of a cell, the probes the traced run
puts around the package's layers, the per-layer readers, and the result
line.

Files, all found by the names in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: the configuration (its ``file``);
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters, whose
  ``generator`` names ``benchmark/traffic/<generator>.py``;
- ``benchmark/limits/<cell>.json``: the limits of the cell's output check;
- ``benchmark/metrics/<metric>.py``: each metric's reader, ``read(rec)``,
  returning its value or None when the run has nothing to read.

A later cell, configuration, traffic mix or metric is new files and
``BENCHMARK.json`` entries; nothing here names one."""

import contextlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch
from torch.profiler import record_function

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
# the measured package's and its libraries' caches: fixed, inside the checkout
CACHE = PACKAGE / "_cache"
# top-level module names no run may hold (compared whole: the measured
# package's name begins with the last one)
FORBIDDEN = ("jax", "jaxlib", "flax", "nmrf_tpu")


def process_start():
    """Epoch seconds at which this process started (``/proc``; the import
    of this module where that is unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def cache_env():
    """Point every compiler cache at fixed directories of the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def log(msg):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


class Cell:
    """One cell of ``BENCHMARK.json`` with its files."""

    def __init__(self, root, name):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        entry = next((w for w in self.bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.chips = name, entry["chips"]
        conf = next(c for c in self.bench["configs"]
                    if c["name"] == entry["config"])
        self.config = json.loads((self.root / conf["file"]).read_text())
        self.traffic = self._json("traffic", entry["traffic"])
        limits = self.root / "benchmark" / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text()) if limits.exists() else {}

    def _json(self, sub, name):
        return json.loads((self.root / "benchmark" / sub / f"{name}.json")
                          .read_text())

    def module(self, sub, name):
        """``benchmark/<sub>/<name>.py`` of the cell's root, else of this
        package."""
        for base in (self.root / "benchmark", PACKAGE):
            path = base / sub / f"{name}.py"
            if path.exists():
                spec = importlib.util.spec_from_file_location(
                    f"benchmark_{sub}_{name.replace('.', '_')}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod
        raise SystemExit(f"no {sub}/{name}.py")

    def metrics(self, kind):
        """The cell's ``end_to_end`` or ``per_layer`` entries."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def spec(self, mode):
        """The configuration's keys as run in ``mode`` (serving or
        training): model, solver, precision, the mode's own, the program's."""
        c = self.config
        out = {}
        for block in ("model", "solver", "precision", mode, "program"):
            out.update(c.get(block, {}))
        return out


def device_for(name, chips):
    """The torch device of a run; exits without a result when a card is
    asked for and fewer than ``chips`` are present."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        raise SystemExit(2)
    return torch.device("cuda", 0)


def port_cfg(spec, seed):
    """The measured package's config tree of a cell: its defaults, then
    every key of ``spec``, the seed last."""
    from nmrf_tpu_torch.config import get_cfg

    cfg = get_cfg()
    opts = []
    for key, value in spec.items():
        opts += [key, value]
    cfg.merge_from_list(opts)
    cfg.SEED = int(seed)
    cfg.freeze()
    return cfg


@contextlib.contextmanager
def strict_f32():
    """Float32 matmuls and convolutions in float32, not TF32, inside the
    block; the settings before it after."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])


def free(device):
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# probes around the measured package's layers (set up in a traced run)
# --------------------------------------------------------------------------- #

STAGE_RANGES = {"backbone": "bench::backbone", "dpn": "bench::dpn",
                "inference": "bench::inference",
                "refinement": "bench::refinement"}
ATTN_RANGE = "bench::window_attention"


def _wrap(module, before):
    forward = module.forward

    def wrapped(*args, **kwargs):
        return before(forward, args, kwargs)

    module.forward = wrapped


def install_probes(model, calls):
    """Ranges around the model's stages and every NMP window attention,
    and a record in ``calls`` of each window attention's (qkv shape,
    window, heads) while ``calls.on`` holds."""
    from nmrf_tpu_torch.models.nmp import WindowAttention

    def ranged(name):
        def before(forward, args, kwargs):
            with record_function(name):
                return forward(*args, **kwargs)
        return before

    for attr, name in STAGE_RANGES.items():
        _wrap(getattr(model, attr), ranged(name))
    for m in model.modules():
        if isinstance(m, WindowAttention):
            def attn(forward, args, kwargs, m=m):
                if calls.on:
                    calls.append((tuple(args[0].shape), m.window_size[0],
                                  m.num_heads))
                with record_function(ATTN_RANGE):
                    return forward(*args, **kwargs)
            _wrap(m, attn)


class Calls(list):
    on = False


def profiled(fn, device, path):
    """Run ``fn()`` under ``torch.profiler`` (the card's activity on a
    card), synchronise, export the chrome trace to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(path))
    return out


# --------------------------------------------------------------------------- #
# the result
# --------------------------------------------------------------------------- #

def read_metrics(cell, kind, rec, on_card):
    """{name: {"value", "unit"}} of the cell's ``kind`` metrics whose
    reader finds something to read.  Off the card only program counters
    are read: no device metric name carries a CPU number."""
    out = {}
    for m in cell.metrics(kind):
        if not on_card and m["source"] != "program_counter":
            continue
        value = cell.module("metrics", m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules():
    """Top-level names in ``sys.modules`` that no run may hold."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(numbers, limits):
    """(correct, checks): every number with a limit within it; a number
    that is NaN, or a limit without a number, fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, checks
