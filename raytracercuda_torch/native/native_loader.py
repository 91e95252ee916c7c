"""ctypes bindings for the port's native OBJ tokenizer
(`raytracercuda_torch/csrc/obj_loader.cpp`; counterpart of
`raytracercuda_tpu/native/native_loader.py`).

The library is built at first use with ``g++ -O2 -std=c++17 -fPIC
-shared`` into ``raytracercuda_torch/_build/`` (git-ignored), its name
carrying a hash of the source and flags, as `ops/cuda_build.py` names the
kernels' library.  `models/loader.parse_obj` falls back to its Python
parser whenever `parse_obj` here returns None: no compiler, a failed
build, or a file the tokenizer cannot open.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "obj_loader.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libobj_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the tokenizer unless it exists; returns its path.  Raises
    `RuntimeError` without a C++ compiler or when the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) for the OBJ tokenizer")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", lib, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"OBJ tokenizer build failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def _load() -> ctypes.CDLL | None:
    """The built library with its C signatures declared, or None when it
    cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.obj_parse.restype = ctypes.c_void_p
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_counts.restype = None
    lib.obj_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.obj_copy.restype = None
    lib.obj_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]
    return lib


def parse_obj(path: str):
    """Parse with the native tokenizer.  Returns the raw-parse tuple
    ``(v, vn, vt, corners, face_mats, mtl_files)`` consumed by
    ``models.loader._finalize_parse``, or None to trigger the Python
    parser."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.obj_parse(os.fsencode(path))
    if not handle:
        return None
    try:
        counts = (ctypes.c_int64 * 6)()
        lib.obj_counts(handle, counts)
        nv, nn, nt, nf, nmat_chars, nmtl_chars = (int(c) for c in counts)
        v = np.empty((nv, 3), np.float32)
        vn = np.empty((nn, 3), np.float32)
        vt = np.empty((nt, 2), np.float32)
        corners = np.empty((nf, 3, 3), np.int64)
        face_mat = np.empty((nf,), np.int32)
        mat_buf = ctypes.create_string_buffer(max(nmat_chars, 1))
        mtl_buf = ctypes.create_string_buffer(max(nmtl_chars, 1))
        lib.obj_copy(
            handle,
            v.ctypes.data_as(ctypes.c_void_p),
            vn.ctypes.data_as(ctypes.c_void_p),
            vt.ctypes.data_as(ctypes.c_void_p),
            corners.ctypes.data_as(ctypes.c_void_p),
            face_mat.ctypes.data_as(ctypes.c_void_p),
            ctypes.cast(mat_buf, ctypes.c_void_p),
            ctypes.cast(mtl_buf, ctypes.c_void_p),
        )
    finally:
        lib.obj_free(handle)

    mat_names = mat_buf.raw[:nmat_chars].decode(errors="replace").split("\n")
    mtl_files = (
        mtl_buf.raw[:nmtl_chars].decode(errors="replace").split("\n")
        if nmtl_chars
        else []
    )
    face_mats = [mat_names[i] for i in face_mat]
    return v, vn, vt, corners, face_mats, mtl_files
