"""The yardstick of the rooflines, frozen here so that a later change to
the program cannot move it: the H100's published peaks, the operations of
one ray-triangle test, a kernel's least time and the tests a tile sweep
needs (copied from `chip_smoke.py`: `FP32_OPS_PER_S`, `HBM_BYTES_PER_S`,
`MT_OPS`, `bound`, `sweep_tests` with its ``active`` rule, `nbytes`)."""

from __future__ import annotations

import torch

#: NVIDIA H100 SXM, published: FP32 outside the tensor cores, and HBM3.
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
#: FP32 operations of one Moller-Trumbore test in `csrc/sweep.cu:mt`: 45
#: adds, subtracts and multiplies, one division, and u + v.
MT_OPS = 46


def bound(ops: float, moved: float) -> float:
    """The least time the card could take, in ms: the larger of ``ops``
    FP32 operations at the FP32 peak and ``moved`` bytes at the device
    memory rate."""
    return max(ops / FP32_OPS_PER_S, moved / HBM_BYTES_PER_S) * 1e3


def sweep_tests(counts: torch.Tensor, rays_per_tile: int, g: int,
                active: torch.Tensor | None = None) -> torch.Tensor:
    """Ray-triangle tests a closest-hit tile sweep needs: every listed
    cluster's ``g`` triangles for each ray of its tile, from the lists'
    per-tile ``counts`` (for each of the ``active`` ``[T, R]`` rays
    alone, where given: an inactive ray tests nothing).  A tensor on the
    lists' device, so that counting waits for nothing."""
    if active is None:
        return counts.sum(dtype=torch.int64) * (rays_per_tile * g)
    return (counts.to(torch.int64) * active.sum(1)).sum() * g


def nbytes(*xs) -> int:
    """Bytes of the tensors in ``xs`` (tensors, or tuples of them); other
    values count 0."""
    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, tuple):
            total += nbytes(*x)
    return total
