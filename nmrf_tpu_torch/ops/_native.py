"""Build and load the hand-written CUDA kernels under ``nmrf_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``nmrf_tpu_torch/_build/lib<name>-<hash>.so`` (the hash covers the source and
the shared headers, so an edited source is rebuilt), then loaded with
``ctypes``.  Nothing is built when the module is imported: the first launch
of a kernel builds it, and :func:`build_all` builds every kernel at once with
one ``nvcc`` process per source.

Every wrapper launches its kernel through :func:`launch`, which also counts
the launches by kernel name (:func:`launch_counts`, :func:`variant_counts`,
:func:`reset_launch_counts`); :func:`recording` and :func:`add_counts` let
a CUDA graph count the kernels it replays (``models/graphs.py``).
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("window_attention", "stripe_attention", "window_attention_bwd",
           "stripe_attention_bwd", "msda_taps", "masked_attention",
           "masked_attention_bwd", "window_attention_pos_bwd", "msda_taps_bwd")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argument types of each library's single entry point (pointers, dtype code,
# shape ints, scale, stream; K1, B5 and B5b then the address of the int in
# which they report the variant they launched, see ``launch``)
_SIGNATURES = {
    "window_attention": ("nmrf_window_attention",
                         [_P] * 3 + [_I] * 13 + [_F, _P, _P]),
    "stripe_attention": ("nmrf_stripe_attention",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _F, _P]),
    "window_attention_bwd": ("nmrf_window_attention_bwd",
                             [_P] * 9 + [_I] * 14 + [_F, _P]),
    "stripe_attention_bwd": ("nmrf_stripe_attention_bwd",
                             [_P] * 9 + [_I] * 9 + [_F, _P]),
    "msda_taps": ("nmrf_msda_taps", [_P] * 5 + [_I] * 13 + [_P, _P]),
    "masked_attention": ("nmrf_masked_attention", [_P] * 5 + [_I] * 7 + [_F, _P]),
    "masked_attention_bwd": ("nmrf_masked_attention_bwd",
                             [_P] * 10 + [_I] * 7 + [_F, _P]),
    "window_attention_pos_bwd": ("nmrf_window_attention_pos_bwd",
                                 [_P] * 6 + [_I] * 14 + [_F, _P]),
    "msda_taps_bwd": ("nmrf_msda_taps_bwd",
                      [_P] * 10 + [_L] + [_I] * 13 + [_P, _P]),
}
# dtype codes of the kernels' ``dtype`` argument (``csrc/common.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_recorder = threading.local()  # .record: the thread's recording()
_loaded = {}
# launches of each kernel, and of K1, B5 and B5b by the variant their entry
# reported, since the last ``reset_launch_counts``
_launches = dict.fromkeys(KERNELS, 0)
_variants = {name: {} for name in ("window_attention", "msda_taps",
                                   "msda_taps_bwd")}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name):
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _command(name, target, csrc=CSRC):
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(target), str(Path(csrc) / f"{name}.cu")]


def build_all(names=KERNELS):
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together.  Returns {name: (seconds, ptxas report)}; raises
    RuntimeError naming each kernel that failed to build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, target)
    report, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        report[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def library(name):
    """The loaded ctypes library of kernel ``name``, built on first use."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        path = _library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
        return fn


def launch(name, *args, variants=None):
    """Launch kernel ``name``'s C entry point on ``args`` and PyTorch's
    current CUDA stream, raise if it returned a CUDA error, and count the
    launch.  An entry that chooses among kernels (K1, B5 and B5b) takes the
    address of an int last, into which it writes the code of the one it
    launched: ``variants`` maps those codes to names, and the launch is
    counted under that name too (raising if no known code was written)."""
    code = ctypes.c_int(-1)
    tail = () if variants is None else (ctypes.addressof(code),)
    err = library(name)(*args, torch.cuda.current_stream().cuda_stream, *tail)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _count(name, variants, code.value)


def _count(name, variants=None, code=None):
    """Count one launch of ``name`` (and of the variant that ``code`` names
    in ``variants``) in the calling thread's :func:`recording`, or else in
    the process's counts."""
    keys = [name]
    if variants is not None:
        variant = variants.get(code)
        if variant is None:
            raise RuntimeError(f"{name}: the kernel reported no known "
                               f"variant ({code})")
        keys.append((name, variant))
    record = getattr(_recorder, "record", None)
    if record is not None:
        for key in keys:
            record[key] = record.get(key, 0) + 1
        return
    add_counts(dict.fromkeys(keys, 1))


@contextlib.contextmanager
def recording():
    """A ``with`` block whose launches, made by the calling thread, are
    counted in the dict it gives ({name or (name, variant): launches}) and
    not in the process's counts: the launches of a CUDA graph's warm-up and
    capture, made on one thread, for :func:`add_counts` at each replay.
    Launches by other threads meanwhile count as ever."""
    outer = getattr(_recorder, "record", None)
    _recorder.record = record = {}
    try:
        yield record
    finally:
        _recorder.record = outer


def reset_launch_counts():
    """Set the launch count of every kernel (``KERNELS``) to 0 and empty
    the per-variant counts of K1, B5 and B5b."""
    with _lock:
        _launches.update(dict.fromkeys(KERNELS, 0))
        for counts in _variants.values():
            counts.clear()


def launch_counts():
    """{kernel name: launches since the last reset}."""
    with _lock:
        return dict(_launches)


def add_counts(delta, times=1):
    """Add ``times`` x ``delta`` ({name or (name, variant): launches}, as
    :func:`recording` keys them) to the counts: a CUDA graph's replay
    counts the port's kernels recorded at its capture."""
    with _lock:
        for key, n in delta.items():
            if isinstance(key, tuple):
                name, variant = key
                _variants[name][variant] = (_variants[name].get(variant, 0)
                                            + times * n)
            else:
                _launches[key] += times * n


def variant_counts():
    """{kernel name: {variant: launches}} of the kernels whose entry point
    chooses among kernels and reports the one it launched: K1
    (``attention.WINDOW_VARIANTS``), B5 and B5b (``msda.MSDA_VARIANTS``,
    ``msda.MSDA_BWD_VARIANTS``)."""
    with _lock:
        return {name: dict(counts) for name, counts in _variants.items()}
