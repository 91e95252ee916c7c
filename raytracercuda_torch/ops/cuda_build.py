"""Build and load the port's CUDA kernels (`csrc/*.cu`).

The sources are compiled with ``nvcc`` at first use, one process per
source, all started together, and linked into one shared library with a
plain C interface in ``raytracercuda_torch/_build/`` (git-ignored).  The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt.  Nothing here runs at import.
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
SOURCES = (_PKG / "csrc" / "sweep.cu", _PKG / "csrc" / "scatter.cu")
BUILD_DIR = _PKG / "_build"
# -fmad=false and IEEE division (no --use_fast_math): every expression
# rounds as the plain PyTorch versions' separate operations do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")


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
    return BUILD_DIR / f"librt_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the library unless it exists; returns (path, seconds spent
    compiling, 0.0 when it was already built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", "-o", obj, str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs = []
        for src, p in zip(SOURCES, procs):
            _, err = p.communicate()
            logs.append((src.name, p.returncode, err))
        failed = [f"{name} ({rc}):\n{err}" for name, rc, err in logs if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        if verbose:
            for name, _, err in logs:
                print(f"{name}:\n{err}", end="")
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
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
    lib.rt_primary.argtypes = [p, p, p, p, p, i, i, i, i, f, p, p, p]
    lib.rt_primary.restype = i
    lib.rt_occlusion_rows.argtypes = [p, p, p, p, p, p, i, i, i, f, p, p]
    lib.rt_occlusion_rows.restype = i
    lib.rt_scatter_add.argtypes = [p, p, i, i, i, i, p, p]
    lib.rt_scatter_add.restype = i
    return lib
