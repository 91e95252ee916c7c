"""The ctypes signatures of the port's CUDA library against its sources.

`ops/cuda_build.SIGNATURES` declares each C entry's argument types for
ctypes.  A pointer declared as an ``int`` is cut to 32 bits and faults
only on the card, so the table is read back here, on the CPU, against the
``extern "C"`` entries of `csrc/*.cu`.
"""

import ctypes
import re

import pytest

from raytracercuda_torch.ops import cuda_build

# C parameter type (qualifiers and the name dropped) -> ctypes type.
_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "unsigned int": ctypes.c_uint, "unsigned": ctypes.c_uint,
            "float": ctypes.c_float}
_ENTRY = re.compile(r"^int\s+(rt_\w+)\s*\(([^)]*)\)\s*\{", re.M)


def _ctype(param: str):
    """The ctypes type ctypes must pass for one C parameter."""
    if "*" in param:
        return ctypes.c_void_p  # a pointer, or the stream as void*
    words = param.replace("const ", "").split()[:-1]  # drop the name
    return _C_TYPES[" ".join(words)]


def c_entries() -> dict:
    """``{name: (ctypes types...)}`` of every ``extern "C"`` entry of the
    sources the library is built from."""
    out = {}
    for src in cuda_build.SOURCES:
        text = src.read_text()
        start = text.index('extern "C" {')
        block = text[start:text.index('}  // extern "C"', start)]
        for name, params in _ENTRY.findall(block):
            params = " ".join(params.split())
            out[name] = tuple(_ctype(p.strip()) for p in params.split(","))
    return out


def test_every_entry_is_declared():
    assert sorted(c_entries()) == sorted(cuda_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(cuda_build.SIGNATURES))
def test_signature_matches_source(name):
    """Arity and kinds: a pointer or the stream ``c_void_p``, ``int``
    ``c_int``, ``long long`` ``c_longlong``, ``unsigned`` ``c_uint``,
    ``float`` ``c_float``."""
    want = c_entries()[name]
    got = cuda_build.SIGNATURES[name]
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is w, (f"{name} argument {i}: {g.__name__}, source "
                        f"{w.__name__}")
