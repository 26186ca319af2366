"""``ops/_native.py``'s table of the kernels' C entry points
(``_SIGNATURES``) against the ``extern "C"`` declarations in ``csrc/``.

ctypes passes each argument as the table says, so a table that disagrees
with its source puts a pointer, an int or a float where the entry reads
another and corrupts memory without an error.  No CUDA is needed: the
sources are parsed.
"""

import ctypes
import re

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
