"""BMP decoder for texture content (a copy of
`raytracercuda_tpu/utils/bmp.py`).

A small self-contained decoder for uncompressed 8-bit paletted and
24/32-bit BMPs, the textures OBJ materials name in ``map_Kd``
(`TestProgram/Model.cpp` loads the textured F16).  Returns float RGB in
[0,1], top-down row order.
"""

from __future__ import annotations

import struct

import numpy as np


def read_bmp(path: str) -> np.ndarray:
    """Decode an uncompressed BI_RGB 24/32-bit (or 8-bit paletted) BMP into
    ``[H,W,3]`` float32 RGB, row 0 = top."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    header_size = struct.unpack_from("<I", data, 14)[0]
    if header_size < 40:
        raise ValueError(f"{path}: unsupported BMP header size {header_size}")
    width, height = struct.unpack_from("<ii", data, 18)
    _, bpp = struct.unpack_from("<HH", data, 26)
    compression = struct.unpack_from("<I", data, 30)[0]
    if compression != 0:
        raise ValueError(f"{path}: compressed BMP not supported")
    flip = height > 0  # positive height = bottom-up storage
    height = abs(height)

    if bpp == 8:
        # Paletted: 256 BGRA entries after the header.
        pal_off = 14 + header_size
        palette = np.frombuffer(data, np.uint8, 256 * 4, pal_off).reshape(256, 4)
        row_stride = (width + 3) & ~3
        rows = np.frombuffer(
            data, np.uint8, row_stride * height, pixel_offset
        ).reshape(height, row_stride)[:, :width]
        rgb = palette[rows][:, :, [2, 1, 0]]
    elif bpp in (24, 32):
        nch = bpp // 8
        row_stride = (width * nch + 3) & ~3
        rows = np.frombuffer(
            data, np.uint8, row_stride * height, pixel_offset
        ).reshape(height, row_stride)
        px = rows[:, : width * nch].reshape(height, width, nch)
        rgb = px[:, :, [2, 1, 0]]  # BGR(A) -> RGB
    else:
        raise ValueError(f"{path}: unsupported bpp {bpp}")

    if flip:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb).astype(np.float32) / 255.0
