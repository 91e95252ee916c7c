"""Kernels I and J (`ops/gradient.py`, `ops/blob.py`; their plain PyTorch
versions, which the wrappers run for CPU tensors) against the JAX package's
`color_gradient` and `blob` (Pallas in interpret mode) and against scalar
transcriptions of the reference's `Gradient.cu` and `Blob.cu`, and
config 1's frame (`clear_buffer` then `color_gradient`).

Tolerances, stated per check:

  * I against a numpy float32 transcription of `Gradient.cu`: equal.  The
    port divides, then multiplies, in float32, as the CUDA kernel does.
  * I against JAX: within 1 per u8 channel, the band structure exact.  XLA
    turns the division by the band width into a multiply by its
    reciprocal, which can land the ramp on the other side of an integer
    (`tests/test_frame_kernels.py:53-59`).
  * J against JAX and against a float64 scalar transcription: within 1 per
    u8 channel.  float32 sin/cos may differ by an ulp between libraries,
    and float64 rounds otherwise (`tests/test_frame_kernels.py:97-100`).
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_u8_close

import jax.numpy as jnp

from raytracercuda_tpu.ops.blob import blob as jax_blob
from raytracercuda_tpu.ops.clear import clear_buffer as jax_clear
from raytracercuda_tpu.ops.gradient import color_gradient as jax_gradient

from raytracercuda_torch.ops import blob as tblob
from raytracercuda_torch.ops import gradient as tgradient
from raytracercuda_torch.ops.clear import clear_buffer

from test_frame_kernels import scalar_gradient


@pytest.mark.parametrize("wh", [(60, 40), (96, 8), (7, 5)])
def test_gradient_matches_reference_and_jax(wh):
    w, h = wh
    tgradient.reset_launch_counts()
    got = tgradient.color_gradient(w, h, device="cpu")
    assert tgradient.launch_counts["gradient"] == 0  # CPU: the plain version
    assert got.dtype == torch.uint32 and got.shape == (w * h,)
    got = got.numpy()
    want = np.asarray(jax_gradient(w, h))
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, scalar_gradient(w * h))
    assert_u8_close(got, want)
    np.testing.assert_array_equal(got == 0, want == 0)
    if (w * h) % 6:
        block = (w * h) // 6
        assert (got[6 * block:] == 0).all()  # past band 5: untouched


def test_gradient_bands():
    got = tgradient.color_gradient(96, 8, device="cpu").numpy()
    block = 96 * 8 // 6
    assert (got[:block] & 0x00FFFF00 == got[:block] & 0x00FF0000).all()
    assert (got[block] & 0x00FF00FF) == 0
    assert (got[2 * block] & 0x00FFFF00) == 0
    assert got[block - 1] == 253 << 16  # 255 * 127/128 = 253.008, truncated


@pytest.mark.parametrize("wh", [(1, 5), (2, 2), (0, 10)])
def test_gradient_below_six_pixels_raises(wh):
    with pytest.raises(ValueError, match=f"{wh[0] * wh[1]}"):
        tgradient.color_gradient(*wh, device="cpu")


def test_gradient_values_clamps_indices():
    i = torch.tensor([0, 5, 11, 12, 40])
    got = tgradient.gradient_values(i, 12)
    # Indices from size on read as index 0.
    assert got[3] == got[0] and got[4] == got[0]
    np.testing.assert_array_equal(got[:3].numpy(),
                                  scalar_gradient(12)[[0, 5, 11]])


def scalar_blob(i, w, h, t):
    """float64 transcription of `Blob.cu:27-58`."""
    ux = (i % w) - w // 2
    uy = (i // w) - h // 2
    s, c = np.sin(t), np.cos(t)
    rx, ry = c * ux - s * uy, s * ux + c * uy
    ry *= 2.0
    dx, dy = abs(rx) - 100.0, abs(ry) - 100.0
    d = min(0.0, max(dx, dy)) + np.hypot(max(dx, 0), max(dy, 0))
    tt = np.clip((d + 1) / 2, 0, 1)
    f = 1 - tt * tt * (3 - 2 * tt)
    shade = 1 - np.clip(d / 1500, 0, 1)
    bg = shade * shade
    mr, mg, mb = bg * (1 - f) + f, bg * (1 - f), bg * (1 - f)

    def pack(x):
        return int(np.clip(x * 255, 0, 255))

    return (pack(mr) << 16) | (pack(mg) << 8) | pack(mb)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("t", [0.0, 1.25, 2.7])
def test_blob_matches_jax_and_scalar(t, as_tensor):
    w, h = 320, 8
    time = torch.tensor(t, dtype=torch.float32) if as_tensor else t
    tblob.reset_launch_counts()
    got = tblob.blob(w, h, time, device="cpu")
    assert tblob.launch_counts["blob"] == 0  # CPU: the plain version
    assert got.dtype == torch.uint32 and got.shape == (w * h,)
    got = got.numpy()
    want = np.asarray(jax_blob(w, h, t))
    assert got.dtype == want.dtype == np.uint32
    assert_u8_close(got, want)
    want = np.array([scalar_blob(i, w, h, t) for i in range(w * h)])
    assert_u8_close(got, want)
    assert len(np.unique(got)) > 10  # edge and background both in frame
    # A float and a tensor of the same time give the same frame.
    other = tblob.blob(w, h, float(t) if as_tensor else
                       torch.tensor(t, dtype=torch.float32), device="cpu")
    np.testing.assert_array_equal(got, other.numpy())


def test_blob_time_is_a_runtime_value():
    a = tblob.blob(320, 8, 0.0, device="cpu")
    b = tblob.blob(320, 8, torch.tensor([0.9]), device="cpu")
    assert not torch.equal(a, b)


def test_kernel_wrappers_reject_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        tgradient._gradient_cuda(64, torch.device("cpu"))
    cpu = torch.device("cpu")
    for time in (torch.zeros(1), 0.5):  # a device tensor, or a float
        with pytest.raises(ValueError, match="CUDA"):
            tblob._blob_cuda(8, 8, time, cpu)


def test_config1_frame():
    """Config 1 (`scripts/bench_configs.py:67-75`): the 256x256 frame
    cleared to 0xFF00FF00, then filled by the gradient."""
    n = 256 * 256
    cleared = clear_buffer(n, 0xFF00FF00, "cpu")
    want = np.asarray(jax_clear(n, jnp.uint32(0xFF00FF00)))
    assert cleared.numpy().dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(cleared.numpy(), want)
    frame = tgradient.color_gradient(256, 256, device="cpu").numpy()
    assert frame.dtype == np.uint32
    np.testing.assert_array_equal(frame, scalar_gradient(n))
    assert_u8_close(frame, np.asarray(jax_gradient(256, 256)))
    assert (frame != cleared.numpy()).all()
