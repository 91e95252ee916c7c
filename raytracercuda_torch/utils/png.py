"""Minimal dependency-free PNG writer (counterpart of
`raytracercuda_tpu/utils/png.py`).

The reference displays frames through a CUDA-mapped OpenGL buffer
(`Raytracer/GLinterop.h`).  Here the framebuffer is copied to the host and
written as a PNG.  Packed pixels may come as uint32 tensors on any device
(the port's framebuffers) or as numpy arrays.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _host_u32(packed) -> np.ndarray:
    if isinstance(packed, torch.Tensor):
        packed = packed.detach().cpu().numpy()
    return np.asarray(packed, np.uint32)


def packed_to_rgb8(packed) -> np.ndarray:
    """``0x00RRGGBB`` framebuffer -> uint8 ``[..., 3]`` RGB (the pack layout
    of `CudaComon.cuh:85-98`)."""
    p = _host_u32(packed)
    return np.stack(
        [(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], axis=-1
    ).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an ``[H, W, 3]`` uint8 array as an RGB PNG."""
    rgb = np.ascontiguousarray(np.asarray(rgb, np.uint8))
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def write_packed_png(path: str, packed, width: int, height: int) -> None:
    """Write a flat packed framebuffer as a PNG."""
    write_png(path, packed_to_rgb8(_host_u32(packed).reshape(height, width)))
