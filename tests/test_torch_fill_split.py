"""Kernels I and J's index plans (`csrc/frame.cu:gradient_kernel`,
`blob_kernel`) replayed in numpy on the CPU.

The kernels run only on the card (`chip_smoke.py` phase 23 holds them
against their plain versions there).  Here `split_gradient` replays I's
band-major plan over a grid of threads: a thread takes ramp positions ``k =
t, t + stride, ...`` below ``block = size // 6``, computes ``c(k)`` once
(float32 division, then a multiply) and stores the six bands at ``b *
block + k``; threads ``t < size - 6 * block`` zero the tail.  `split_blob` replays J's: a block takes a chunk of four-pixel
groups of rows ``y, y + grid_rows, ...``; thread ``q`` computes columns
``4q .. 4q + 3`` and stores them with one 16-byte store where ``w % 4 ==
0`` (every row start aligned), else those below ``w`` one by one; ``ux``
and ``uy`` come from the column and the row.  Each replay must write
every pixel exactly once, and every 16-byte store must be aligned.

Tolerances, stated per check:

  * Each replay against its plain version (`gradient_values`,
    `blob_values`): equal.  Float32 arithmetic in numpy rounds each
    operation once, as the kernel built with ``-fmad=false`` does, and the
    row's ``s * uy`` and ``c * uy`` are the same products as the plain
    version's.
  * I's replay against a transcription of `Gradient.cu`
    (`test_frame_kernels.scalar_gradient`): equal; against JAX: within 1
    per u8 channel (`tests/test_torch_frame_kernels.py`: XLA multiplies
    by the reciprocal of the band width).
  * J's replay against JAX: within 1 per u8 channel (float32 sin/cos may
    differ by an ulp between libraries).
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_u8_close, time_limit

from raytracercuda_tpu.ops.blob import blob as jax_blob
from raytracercuda_tpu.ops.gradient import color_gradient as jax_gradient

from raytracercuda_torch.ops import blob as tblob
from raytracercuda_torch.ops import gradient as tgradient

from test_frame_kernels import scalar_gradient

F32 = np.float32
# `launch.cuh:kThreads`; I's grid is `card_grid(block)`, at most 4 blocks
# a multiprocessor (the stride below is one such grid and a short one).
THREADS = 256
BLOB_TIMES = (0.0, 1.25, 2.7)  # chip_smoke.py's phase 23


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test's own limit: far above its time on one worker (< 5 s)."""
    with time_limit(60):
        yield


def ramp(k, block: int) -> np.ndarray:
    """``c(k)``: int32(float32(k) / float32(block) * 255), as uint32."""
    c = np.asarray(k).astype(F32) / F32(block) * F32(255)
    return c.astype(np.int32).astype(np.uint32)


def bands(c):
    """The six bands' packed colours of ramp value ``c``."""
    return [c << 16, c << 8, c, (c << 16) | (c << 8), (c << 8) | c,
            (c << 16) | c]


def split_gradient(size: int, stride: int) -> np.ndarray:
    """Kernel I's plan over ``stride`` threads: ``[size]`` uint32 pixels,
    each written once.  The threads' grid-stride loops run side by side:
    step ``i`` of thread ``t`` takes ramp position ``t + i * stride``."""
    block = size // 6
    out = np.zeros(size, np.uint32)
    writes = np.zeros(size, np.int64)
    steps = -(-block // stride)
    k = (np.arange(stride)[None, :]
         + stride * np.arange(steps)[:, None]).reshape(-1)
    k = k[k < block]
    for b, v in enumerate(bands(ramp(k, block))):
        out[b * block + k] = v
        np.add.at(writes, b * block + k, 1)
    tail = np.arange(min(stride, size - 6 * block))  # threads t < the tail
    out[6 * block + tail] = 0
    writes[6 * block + tail] += 1
    assert (writes == 1).all(), "a pixel written twice or never"
    return out


def blob_launch(w: int, h: int) -> tuple:
    """``rt_blob``'s launch: (threads a block, chunks of four-pixel groups
    a row, grid rows)."""
    groups = -(-w // 4)
    threads = min((groups + 31) // 32 * 32, THREADS)
    return threads, -(-groups // threads), min(h, 65535)


def blob_pixel(ux, s, c, s_uy, c_uy):
    """`frame.cu:blob_pixel` in numpy float32."""
    rx = c * ux - s_uy
    ry = (s * ux + c_uy) * F32(2)
    dx = np.abs(rx) - F32(100)
    dy = np.abs(ry) - F32(100)
    inside = np.minimum(F32(0), np.maximum(dx, dy))
    lx = np.maximum(dx, F32(0))
    ly = np.maximum(dy, F32(0))
    d = inside + np.sqrt(lx * lx + ly * ly)
    st = np.minimum(np.maximum((d - F32(-1)) / F32(2), F32(0)), F32(1))
    f = F32(1) - st * st * (F32(3) - F32(2) * st)
    shade = F32(1) - np.minimum(np.maximum(d / F32(1500), F32(0)), F32(1))
    bg = shade * shade
    keep = F32(1) - f
    mr = bg * keep + F32(1) * f
    mg = bg * keep

    def u8(x):
        y = np.minimum(np.maximum(x * F32(255), F32(0)), F32(255))
        return y.astype(np.int32).astype(np.uint32)

    return (u8(mr) << 16) | (u8(mg) << 8) | u8(mg)


def split_blob(w: int, h: int, time: float, grid_rows=None) -> np.ndarray:
    """Kernel J's plan: ``[w*h]`` uint32 pixels, each written once; a
    group's 16-byte store (``w % 4 == 0``) at a multiple of 4.
    ``grid_rows`` overrides the launch's grid rows (each block then strides
    over rows)."""
    threads, chunks, rows = blob_launch(w, h)
    rows = rows if grid_rows is None else grid_rows
    tm = torch.tensor([time], dtype=torch.float32)
    s = F32(torch.sin(tm).item())  # the card's sinf/cosf in the kernel
    c = F32(torch.cos(tm).item())
    half_w, half_h = F32(w // 2), F32(h // 2)
    out = np.zeros(w * h, np.uint32)
    writes = np.zeros(w * h, np.int64)
    col = 4 * np.arange(chunks * threads)  # a thread's first column
    col = col[col < w]  # the others return
    ux = col.astype(F32) - half_w
    for y in range(rows):
        for row in range(y, h, rows):
            base = row * w
            uy = F32(row) - half_h
            s_uy, c_uy = s * uy, c * uy
            if w % 4 == 0:
                assert ((base + col) % 4 == 0).all(), "a store not aligned"
            for j in range(4):
                px = blob_pixel(ux + F32(j), s, c, s_uy, c_uy)
                x = col + j
                if w % 4 == 0:
                    assert (x < w).all()
                keep = x < w
                out[base + x[keep]] = px[keep]
                writes[base + x[keep]] += 1
    assert (writes == 1).all(), "a pixel written twice or never"
    return out


GRADIENT_SIZES = {  # name: (width, height); block 1 at 6, 7 and 11
    "6": (6, 1), "7": (7, 1), "11": (11, 1), "60x40": (60, 40),
    "96x8": (96, 8), "255x257": (255, 257),
}


@pytest.mark.parametrize("stride", [THREADS, 5])
@pytest.mark.parametrize("name", sorted(GRADIENT_SIZES))
def test_split_gradient_matches_plain(name, stride):
    w, h = GRADIENT_SIZES[name]
    size = w * h
    got = split_gradient(size, stride)
    plain = tgradient.gradient_values(torch.arange(size), size).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, scalar_gradient(size))
    if stride == THREADS:
        want = np.asarray(jax_gradient(w, h))
        assert got.dtype == plain.dtype == want.dtype == np.uint32
        assert_u8_close(got, want)


# The sizes `chip_smoke.py` holds the kernels to: config 1's 256x256,
# 1920x1080 and an odd 255x257 (odd pixel count, no row 16-byte aligned).
FRAME_SIZES = {"256x256": (256, 256), "1920x1080": (1920, 1080),
               "255x257": (255, 257)}


@pytest.mark.parametrize("grid", ["card", "one_block"])
@pytest.mark.parametrize("name", sorted(FRAME_SIZES))
def test_split_gradient_frame_sizes(name, grid):
    """I's plan at the card's sizes, over one full grid of threads
    (`card_grid`: 132 multiprocessors, 4 blocks each, at most) and over one
    block of threads striding over the whole band: every pixel written
    once, equal to the plain version."""
    w, h = FRAME_SIZES[name]
    size = w * h
    block = size // 6
    stride = THREADS
    if grid == "card":
        stride *= min(-(-block // THREADS), 132 * 4)
    plain = tgradient.gradient_values(torch.arange(size), size).numpy()
    np.testing.assert_array_equal(split_gradient(size, stride), plain)


@pytest.mark.parametrize("name", sorted(FRAME_SIZES))
def test_split_blob_frame_sizes(name):
    """J's plan at the card's sizes: every pixel written once, equal to
    the plain version; 16-byte stores at 256 and 1920, one by one at 255."""
    w, h = FRAME_SIZES[name]
    time = torch.tensor([1.25], dtype=torch.float32)
    np.testing.assert_array_equal(
        split_blob(w, h, 1.25),
        tblob.blob_values(torch.arange(w * h), w, h, time).numpy())


def test_split_gradient_block_one():
    """size 6..11: block 1, each band one pixel of c(0) = 0, the tail of up
    to 5 pixels zero."""
    for size in range(6, 12):
        got = split_gradient(size, THREADS)
        assert (got == 0).all()
        np.testing.assert_array_equal(
            got, tgradient.gradient_values(torch.arange(size), size).numpy())


@pytest.mark.parametrize("size", [6 * 2**29 + 5, 2**31 + 7, 3 * 2**31 + 1])
def test_split_gradient_64bit(size):
    """Kernel I's 64-bit branch (size >= 2^31): the plan at ramp positions
    whose pixels lie around 2^31, at band edges and in the tail, through
    `gradient_values` on those indices alone (no frame is allocated)."""
    assert size >= 2**31
    block = size // 6
    near = np.arange(2**31 - 3, 2**31 + 3)
    ks = np.unique(np.concatenate([
        [0, 1, 2**24 + 1, block // 2, block - 2, block - 1],
        near % block]))
    c = ramp(ks, block)
    idx, want = [], []
    for b, v in enumerate(bands(c)):
        idx.append(b * block + ks)
        want.append(v)
    tail = np.arange(6 * block, size)
    idx = np.concatenate(idx + [tail])
    want = np.concatenate(want + [np.zeros(len(tail), np.uint32)])
    assert (idx >= 2**31).any() and (idx < 2**31).any()
    assert np.isin(near, idx).all()
    got = tgradient.gradient_values(torch.from_numpy(idx), size).numpy()
    np.testing.assert_array_equal(got, want)


BLOB_SIZES = {  # name: (width, height)
    "even": (320, 8), "odd_width_odd_count": (321, 7),
    "odd_width_even_count": (255, 4), "w1": (1, 9), "w2": (2, 5),
    "256x3": (256, 3), "wide_chunks": (601, 3),
}


@pytest.mark.parametrize("t", BLOB_TIMES)
@pytest.mark.parametrize("name", sorted(BLOB_SIZES))
def test_split_blob_matches_plain(name, t):
    w, h = BLOB_SIZES[name]
    got = split_blob(w, h, t)
    time = torch.tensor([t], dtype=torch.float32)
    plain = tblob.blob_values(torch.arange(w * h), w, h, time).numpy()
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(jax_blob(w, h, t))
    assert got.dtype == plain.dtype == want.dtype == np.uint32
    assert_u8_close(got, want)


@pytest.mark.parametrize("grid_rows", [1, 3])
def test_split_blob_rows_stride(grid_rows):
    """Fewer grid rows than frame rows (the launch caps them at 65,535):
    each block strides over rows, with the same pixels."""
    w, h = 97, 11
    got = split_blob(w, h, 1.25, grid_rows=grid_rows)
    np.testing.assert_array_equal(got, split_blob(w, h, 1.25))


def test_split_blob_edge_in_frame():
    """At 256x256 (config 1) the square's edge and the background are in
    frame, so the replay covers every branch of the pixel function."""
    got = split_blob(256, 256, 1.25)
    time = torch.tensor([1.25], dtype=torch.float32)
    plain = tblob.blob_values(torch.arange(256 * 256), 256, 256,
                              time).numpy()
    np.testing.assert_array_equal(got, plain)
    red = (got >> 16) & 0xFF
    assert (got == 0xFF0000).any() and (red < 255).any()


@pytest.mark.parametrize("w", [1, 2, 63, 64, 65, 511, 512, 513, 1920])
def test_blob_launch_covers_pairs(w):
    """Threads a block are whole warps, at most 256, and the chunks cover
    a row's four-pixel groups (its pixels four at a time) with no chunk
    idle."""
    threads, chunks, rows = blob_launch(w, 7)
    groups = -(-w // 4)
    assert threads % 32 == 0 and 32 <= threads <= THREADS
    assert chunks * threads >= groups and chunks >= 1 and rows == 7
    assert (chunks - 1) * threads < groups


def test_blob_wrapper_reads_a_cuda_time():
    """`_blob_cuda` reads a tensor time in place, so it must lie on the
    card: a CPU tensor raises before anything is launched."""
    with pytest.raises(ValueError, match="CUDA float32 time"):
        tblob._blob_cuda(8, 8, torch.zeros(1), torch.device("cuda"))
