"""``ops/_native.py``'s table of the kernels' C entry points
(``_SIGNATURES``) against the ``extern "C"`` declarations in ``csrc/``,
and the counts that a CUDA graph's capture records and its replay adds.

ctypes passes each argument as the table says, so a table that disagrees
with its source puts a pointer, an int or a float where the entry reads
another and corrupts memory without an error.  No CUDA is needed: the
sources are parsed.
"""

import ctypes
import re
import threading

import pytest

from nmrf_tpu_torch.ops import _native

_CTYPE_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
                ctypes.c_longlong: "long long", ctypes.c_float: "float"}
_C_KINDS = {"int": "int", "long long": "long long", "float": "float"}


def _c_kind(param):
    """The kind of one C parameter declaration, e.g. ``const void* q``."""
    if "*" in param:
        return "pointer"
    return _C_KINDS[" ".join(param.split()[:-1])]


@pytest.mark.parametrize("name", _native.KERNELS)
def test_signature_matches_the_c_entry(name):
    symbol, argtypes = _native._SIGNATURES[name]
    src = (_native.CSRC / f"{name}.cu").read_text()
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert len(entries) == 1, entries
    c_symbol, params = entries[0]
    assert c_symbol == symbol == f"nmrf_{name}"
    assert [_c_kind(p) for p in params.split(",")] == \
        [_CTYPE_KINDS[t] for t in argtypes]


def _nonzero():
    return ({k: n for k, n in _native.launch_counts().items() if n},
            {k: v for k, v in _native.variant_counts().items() if v})


def test_added_counts_round_trip():
    """``add_counts`` adds to the launch and variant counts what
    ``recording`` keys (a CUDA graph's replay, ``models/graphs.py``), and
    takes it back out with ``times`` -1."""
    _native.reset_launch_counts()
    delta = {"stripe_attention": 10, "msda_taps": 4,
             ("msda_taps", "vector"): 4}
    _native.add_counts(delta, 3)
    assert _nonzero() == ({"stripe_attention": 30, "msda_taps": 12},
                          {"msda_taps": {"vector": 12}})
    _native.add_counts(delta, -3)
    assert _nonzero() == ({}, {"msda_taps": {"vector": 0}})
    _native.reset_launch_counts()


def test_recording_takes_the_calling_threads_launches_only():
    """Inside ``recording`` the calling thread's launches, and their
    variants, go to its record and not to the counts; another thread's
    launches meanwhile, and the thread's own after the block, count as
    ever."""
    _native.reset_launch_counts()
    variants = {3: "vector"}
    with _native.recording() as record:
        _native._count("msda_taps", variants, 3)
        other = threading.Thread(target=_native._count,
                                 args=("stripe_attention",))
        other.start()
        other.join()
    _native._count("window_attention")
    assert record == {"msda_taps": 1, ("msda_taps", "vector"): 1}
    assert _nonzero() == ({"stripe_attention": 1, "window_attention": 1},
                          {})
    with pytest.raises(RuntimeError, match="no known variant"):
        _native._count("msda_taps", variants, -1)
    _native.reset_launch_counts()
