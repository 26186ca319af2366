"""Host (C++) runtime components of the port, loaded with ctypes: the
fused photometric augmentation (``photometric.cpp``, the port's copy of
``nmrf_tpu/native/photometric.cpp``) that replaces the PIL ColorJitter /
AdjustGamma chain of ``data/transforms.py``.

The first ``load()`` compiles the single translation unit with
``g++ -O3 -shared -fPIC`` into ``nmrf_tpu_torch/_build/`` (the file name
carries the source's hash, so an edited source is rebuilt) and raises if
the build fails: the PIL chain is the plain version, which runs only where
a caller asks for it (``transforms.fused_photometric(..., plain=True)``).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).with_name("photometric.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_lock = threading.Lock()
_lib = None


def _build():
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libphotometric-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp),
           str(SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        detail = getattr(e, "stderr", "") or e
        raise RuntimeError(f"building {SRC.name} failed: {detail}") from e
    tmp.replace(lib)  # atomic: loader processes may build at once
    return lib


def load():
    """The loaded library (built on first use); raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.nmrf_photometric.argtypes = [
                u8p, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                u8p, ctypes.c_int]
            lib.nmrf_photometric.restype = None
            for name in ("nmrf_rgb2hsv", "nmrf_hsv2rgb"):
                fn = getattr(lib, name)
                fn.argtypes = [u8p, u8p, ctypes.c_longlong]
                fn.restype = None
            _lib = lib
        return _lib
