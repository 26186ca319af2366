"""Build and load the hand-written CUDA kernels under ``nmrf_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``nmrf_tpu_torch/_build/lib<name>-<hash>.so`` (the hash covers the source and
the shared headers, so an edited source is rebuilt), then loaded with
``ctypes``.  Nothing is built when the module is imported: the first launch
of a kernel builds it, and :func:`build_all` builds every kernel at once with
one ``nvcc`` process per source.
"""

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
           "masked_attention_bwd", "window_attention_pos_bwd")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of each library's single entry point (pointers, dtype code,
# shape ints, scale, stream)
_SIGNATURES = {
    "window_attention": ("nmrf_window_attention", [_P] * 3 + [_I] * 13 + [_F, _P]),
    "stripe_attention": ("nmrf_stripe_attention",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _F, _P]),
    "window_attention_bwd": ("nmrf_window_attention_bwd",
                             [_P] * 9 + [_I] * 14 + [_F, _P]),
    "stripe_attention_bwd": ("nmrf_stripe_attention_bwd",
                             [_P] * 9 + [_I] * 9 + [_F, _P]),
    "msda_taps": ("nmrf_msda_taps", [_P] * 5 + [_I] * 10 + [_P]),
    "masked_attention": ("nmrf_masked_attention", [_P] * 5 + [_I] * 7 + [_F, _P]),
    "masked_attention_bwd": ("nmrf_masked_attention_bwd",
                             [_P] * 10 + [_I] * 7 + [_F, _P]),
    "window_attention_pos_bwd": ("nmrf_window_attention_pos_bwd",
                                 [_P] * 6 + [_I] * 14 + [_F, _P]),
}
# dtype codes of the kernels' ``dtype`` argument (``csrc/common.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_loaded = {}


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


def stream():
    """PyTorch's current CUDA stream, as a kernel's ``stream`` argument."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check_launch(kernel, err):
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
