"""Scatter-add, the backward of the differentiable route's per-ray row
gathers (counterpart of `raytracercuda_tpu/diff/scatter.py:112-315`).

`_rows_recompute_shade` gathers one attribute row per ray; the backward
of that gather is ``out[idx[n]] += g[n]``.  Kernel G (`csrc/scatter.cu`,
replacing `scatter._scatter_kernel`) writes the output's zeros itself and
adds each kept ray's ``D`` cotangents into its row with float atomics,
``_atomic_width(D)`` floats at a time.

The JAX package's per-tile windows (`tile_bases`), their 128-alignment
and the exact fallbacks for rays outside every window (the stray
compaction under ``stray_cap`` and the full ``segment_sum``) exist only
because the TPU's grid runs in order on one core and its kernel keeps a
window of the output in VMEM.  Kernel G adds straight into the output and
is exact for every id, so none of them has a counterpart here.  Float
atomics sum in an order that changes from run to run: G agrees with its
plain version to float32 rounding, not bit for bit.

Under `torch.use_deterministic_algorithms(True)`, G takes a sorted route
instead: a stable sort of the ids (`sorted_segments`, torch ops) and a
segment sum (`csrc/scatter.cu:segment_sum_kernel`) that adds each row's
terms in ascending (tile, ray) order, as ``index_add_`` on the CPU does,
so that the result is bitwise repeatable and equal to the plain version
on the CPU.

`tile_scatter_add` runs G's plain version (``index_add_``) for tensors on
the CPU and launches G for tensors on a GPU; there is no fallback from
one to the other.  One launch of G is one call of its C entry, which
writes the output's zeros and scatters into it (two kernels), or writes
the sorted route's sums (one kernel); ``launch_counts`` counts those
calls.
"""

from __future__ import annotations

import torch

from ..ops.cuda_build import kernel_fn, raw_stream
from ..trace import sweep
from ..utils.profiler import span

#: Kernel launches, counted where the kernel is launched.
launch_counts = {"scatter_add": 0, "scatter_sorted": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _atomic_width(d: int) -> int:
    """Floats per atomic add of kernel G for rows of ``d`` columns: 4
    (``float4``) when 4 divides ``d``, 2 (``float2``) when 2 does, else 1.
    A row of ``d`` floats then starts on a multiple of that width."""
    return 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1


def _scatter_add_plain(g: torch.Tensor, idx: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Plain version of kernel G: ``[num_rows, D]`` sums of the planar
    ``[T, D, B]`` cotangents by ``[T, B]`` row id; ids outside
    ``[0, num_rows)`` are dropped."""
    d = g.shape[1]
    rows = g.transpose(1, 2).reshape(-1, d)
    flat = idx.reshape(-1).long()
    keep = (flat >= 0) & (flat < num_rows)
    out = torch.zeros((num_rows, d), dtype=torch.float32, device=g.device)
    return out.index_add_(0, flat[keep], rows[keep])


def _scatter_add_cuda(g: torch.Tensor, idx: torch.Tensor, num_rows: int,
                      overlap: bool = True) -> torch.Tensor:
    """Launch kernel G; output as in `_scatter_add_plain`.  ``overlap``
    launches the scatter with programmatic dependent launch, so that it
    starts during the fill (False: plain stream order, kept to time the
    two against each other)."""
    t, d, b = g.shape
    dev = g.device
    # One pass over the conditions; `_check_cuda` names the one that fails.
    if not (g.is_cuda and g.dtype == torch.float32 and g.is_contiguous()
            and idx.dtype == torch.int32 and idx.is_contiguous()
            and idx.shape == (t, b) and idx.device == dev):
        sweep._check_cuda("g", g, dev, torch.float32, (t, d, b))
        sweep._check_cuda("idx", idx, dev, torch.int32, (t, b))
    if not 0 <= num_rows < 1 << 31:
        raise ValueError(f"kernel G takes 0 to 2^31 - 1 rows, got {num_rows}")
    out = g.new_empty((num_rows, d))  # float32 on g's card
    err = kernel_fn("rt_scatter_add")(
        g.data_ptr(), idx.data_ptr(), t, d, b, num_rows, _atomic_width(d),
        overlap, out.data_ptr(), raw_stream(dev))
    if err:
        raise RuntimeError(f"kernel G launch failed: CUDA error {err}")
    launch_counts["scatter_add"] += 1
    return out


def sorted_segments(idx: torch.Tensor, num_rows: int):
    """The sorted route's operands, from torch ops alone: ``order`` (int32)
    the flat ray positions ``t * B + j`` sorted by row id, stably, so each
    row's rays stay in ascending (tile, ray) order, the dropped ids last;
    ``seg`` ``[num_rows + 1]`` (int32) the bounds of row ``r``'s run,
    ``order[seg[r]:seg[r + 1]]``."""
    flat = idx.reshape(-1).to(torch.int32)
    keep = (flat >= 0) & (flat < num_rows)
    key = torch.where(keep, flat, num_rows)
    key, order = torch.sort(key, stable=True)
    rows = torch.arange(num_rows + 1, dtype=torch.int32, device=idx.device)
    seg = torch.searchsorted(key, rows, out_int32=True)
    return order.to(torch.int32), seg


def _scatter_add_sorted_cuda(g: torch.Tensor, idx: torch.Tensor,
                             num_rows: int) -> torch.Tensor:
    """Launch G's sorted route: `sorted_segments`, then one thread per
    output float sums its row's terms in ascending (tile, ray) order.
    Output as in `_scatter_add_plain`, and bitwise equal to it on the
    CPU."""
    t, d, b = g.shape
    dev = g.device
    sweep._check_cuda("g", g, dev, torch.float32, (t, d, b))
    sweep._check_cuda("idx", idx, dev, torch.int32, (t, b))
    if not 0 <= num_rows < 1 << 31 or t * b >= 1 << 31:
        raise ValueError(f"the sorted route takes 0 to 2^31 - 1 rows and "
                         f"rays, got {num_rows} rows, {t * b} rays")
    order, seg = sorted_segments(idx, num_rows)
    out = g.new_empty((num_rows, d))
    err = kernel_fn("rt_segment_sum")(
        g.data_ptr(), order.data_ptr(), seg.data_ptr(), d, b, num_rows,
        out.data_ptr(), raw_stream(dev))
    if err:
        raise RuntimeError(f"kernel G (sorted) launch failed: CUDA error "
                           f"{err}")
    launch_counts["scatter_sorted"] += 1
    return out


def tile_scatter_add(g: torch.Tensor, idx: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """``out[idx[t, j]] += g[t, :, j]`` -> ``[num_rows, D]`` float32.

    ``g`` ``[T, D, B]`` float32 cotangents, rays last (planar); ``idx``
    ``[T, B]`` int32 rows, ids below 0 (and from ``num_rows`` up)
    dropped.  On a GPU under `torch.use_deterministic_algorithms(True)`
    it takes G's sorted route, bitwise repeatable."""
    cuda = (_scatter_add_sorted_cuda
            if torch.are_deterministic_algorithms_enabled()
            else _scatter_add_cuda)
    run = sweep._pick(g, _scatter_add_plain, cuda)
    return run(g.contiguous(), idx.to(torch.int32).contiguous(), num_rows)


def _retile_2d(x: torch.Tensor, frame_hw, tp: int) -> torch.Tensor:
    """Row-major ``[H*W, ...]`` -> pixel-tile-major ``[T, tp*tp, ...]``.

    A ``tp x tp`` pixel square hits far fewer, closer slot ids than a
    strip of as many row-major pixels, so a tile's atomics meet fewer
    rows."""
    h, w = frame_hw
    lead = tuple(x.shape[1:])
    x = x.reshape((h // tp, tp, w // tp, tp) + lead).transpose(1, 2)
    return x.reshape(((h // tp) * (w // tp), tp * tp) + lead)


def check_frame_hw(frame_hw, num_rays: int) -> None:
    """Raise unless a ``frame_hw`` of ``(H, W)`` covers ``num_rays``."""
    if frame_hw is not None and frame_hw[0] * frame_hw[1] != num_rays:
        raise ValueError(
            f"frame_hw {tuple(frame_hw)} holds {frame_hw[0] * frame_hw[1]} "
            f"pixels, but there are {num_rays} rays")


class _GatherRowsTiled(torch.autograd.Function):

    @staticmethod
    def forward(ctx, rows, idx, tile_shape, frame_hw):
        ctx.save_for_backward(idx)
        ctx.num_rows = rows.shape[0]
        ctx.tile_shape = tile_shape
        ctx.frame_hw = frame_hw
        return rows[idx.clamp(min=0).long()]

    @staticmethod
    def backward(ctx, gr):
        (idx,) = ctx.saved_tensors
        t, b = ctx.tile_shape
        frame_hw = ctx.frame_hw
        tp = int(round(b ** 0.5))
        if (frame_hw is not None and tp * tp == b
                and frame_hw[0] % tp == 0 and frame_hw[1] % tp == 0):
            idx_t = _retile_2d(idx, frame_hw, tp)
            g_t = _retile_2d(gr, frame_hw, tp).transpose(1, 2)  # [T, D, B]
        else:
            idx_t = idx.reshape(t, b)
            g_t = gr.reshape(t, b, -1).transpose(1, 2)
        with span("scatter.G"):
            d_rows = tile_scatter_add(g_t, idx_t, ctx.num_rows)
        # The forward gathered row 0 for misses (id < 0), which G drops:
        # credit their cotangent to row 0 with one masked reduction.
        miss = (idx < 0)[:, None]
        d_rows[0] += torch.where(miss, gr, 0.0).sum(dim=0)
        return d_rows, None, None, None


def gather_rows_tiled(rows: torch.Tensor, idx: torch.Tensor, tile_shape,
                      frame_hw=None) -> torch.Tensor:
    """``rows[max(idx, 0)]`` -> ``[N, D]``, whose backward is kernel G.

    ``idx [N]`` int32 comes in ``tile_shape = (T, B)`` blocks of rays;
    when ``frame_hw`` is given and a ``sqrt(B)``-pixel square tiles it,
    the backward re-tiles the rays into pixel squares (`_retile_2d`)
    instead of row-major strips.  Negative ids gather row 0, and their
    cotangent goes to row 0, as the plain gather's backward does."""
    check_frame_hw(frame_hw, idx.shape[0])
    t, b = tile_shape
    if t * b != idx.shape[0]:
        raise ValueError(f"tile_shape {tuple(tile_shape)} does not cover "
                         f"{idx.shape[0]} rays")
    return _GatherRowsTiled.apply(rows, idx,
                                  tuple(tile_shape),
                                  None if frame_hw is None
                                  else tuple(frame_hw))
