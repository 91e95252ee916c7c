"""Build and load the port's CUDA kernels (`csrc/*.cu`).

The sources are compiled with ``nvcc`` into one shared library with a
plain C interface, at first use, into ``raytracercuda_torch/_build/``
(git-ignored).  The library's name carries a hash of the sources and
flags, so an edited source is rebuilt.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "sweep.cu",)
BUILD_DIR = _PKG / "_build"
# -fmad=false and IEEE division (no --use_fast_math): every expression
# rounds as the plain PyTorch versions' separate operations do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"librt_sweep_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the library unless it exists; returns (path, seconds spent
    compiling, 0.0 when it was already built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, time.perf_counter() - t0


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_primary_shade.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, p, p,
                                     p]
    lib.rt_primary_shade.restype = i
    lib.rt_occlusion.argtypes = [p, p, p, p, p, p, i, i, i, f, p, p]
    lib.rt_occlusion.restype = i
    return lib
