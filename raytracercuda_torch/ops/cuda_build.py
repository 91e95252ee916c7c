"""Build and load the port's CUDA kernels (`csrc/*.cu`).

The sources are compiled with ``nvcc`` at first use, one process per
source, all started together, and linked into one shared library with a
plain C interface in ``raytracercuda_torch/_build/`` (git-ignored).  The
library's name carries a hash of the sources, headers and flags, so an
edited source is rebuilt.  Nothing here runs at import.

`kernel_fn` and `raw_stream` are every wrapper's launch path (A-M, the
culls and the frame's shading kernels): the library's function looked up once, and the current
stream's handle without building a `torch.cuda.Stream`.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in
                ("sweep.cu", "scatter.cu", "brute.cu", "frame.cu",
                 "bvh.cu", "grid.cu", "cull.cu"))
HEADERS = tuple(_PKG / "csrc" / name for name in
                ("launch.cuh", "hit_key.cuh", "mt.cuh"))
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
    for src in SOURCES + HEADERS:
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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64, _U32 = ctypes.c_longlong, ctypes.c_uint

#: The argument types of each C entry of `csrc/*.cu`, in order: a pointer
#: or the stream is ``c_void_p`` (passed bare, ctypes would cut it to a
#: 32-bit int), ``int`` ``c_int``, ``long long`` ``c_longlong``,
#: ``unsigned int`` ``c_uint``, ``float`` ``c_float``.  Each entry returns
#: its first launch error as an ``int``.
SIGNATURES = {
    "rt_primary_shade": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _F, _P, _P, _P, _P, _P),
    "rt_general_shade": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _F, _P, _P, _P, _P),
    "rt_occlusion": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P,
                     _P),
    "rt_primary": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P,
                   _P, _P, _P),
    "rt_closest_rays": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P,
                        _P, _P, _P),
    "rt_occlusion_rows": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                          _P, _P, _P),
    "rt_scatter_add": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "rt_segment_sum": (_P, _P, _P, _I, _I, _I, _P, _P),
    "rt_brute": (_P, _P, _P, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P, _P, _P),
    "rt_clear": (_P, _I64, _U32, _P),
    "rt_gradient": (_P, _I64, _P),
    "rt_blob": (_P, _I, _I, _P, _F, _P),
    "rt_shadow_setup": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I64, _P, _P, _P,
                        _P),
    "rt_frame_shade": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                       _F, _F, _F, _F, _I, _I, _I64, _P, _P),
    "rt_walk_closest": (_P, _P, _I, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P,
                        _P),
    "rt_walk_any": (_P, _P, _I, _P, _P, _P, _I, _I, _F, _P, _P),
    "rt_beam": (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                _F, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P),
    "rt_chase": (_P, _I, _I, _P, _P),
    "rt_grid_march": (_P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _I, _F, _F,
                      _I, _I, _I, _F, _P, _P, _P, _P, _P),
    "rt_frustum_cull": (_P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P),
    "rt_beam_cull": (_P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P),
    "rt_general_cull": (_P, _P, _P, _I, _I, _P, _P, _I, _P, _P),
}

#: Bytes a pixel of the packed frames that `rt_clear`, `rt_gradient` and
#: `rt_blob` write: uint32, as `ops/math.py` hands frames out.
PIXEL_BYTES = 4


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with its C signatures (`SIGNATURES`) declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = _I
    return lib


_KERNEL_FNS: dict[str, ctypes._CFuncPtr] = {}


def kernel_fn(name: str) -> ctypes._CFuncPtr:
    """The library's C entry ``name`` with its signature declared, built
    and loaded at the first call and looked up once."""
    fn = _KERNEL_FNS.get(name)
    if fn is None:
        fn = _KERNEL_FNS[name] = getattr(load_library(), name)
    return fn


def raw_stream(device: torch.device | int) -> int:
    """The handle of ``device``'s current CUDA stream, as
    `torch.cuda.current_stream(device).cuda_stream` gives it (0 for the
    default stream) but through `torch._C._cuda_getCurrentRawStream`,
    without building a `Stream` object.  Raises `RuntimeError` when torch
    has no CUDA."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is None:
        raise RuntimeError(
            "torch has no CUDA (torch._C._cuda_getCurrentRawStream is "
            "missing): no stream to launch a kernel on")
    index = device if isinstance(device, int) else device.index
    return get(torch.cuda.current_device() if index is None else index)
