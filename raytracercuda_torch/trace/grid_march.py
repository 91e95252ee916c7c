"""DDA cell-walking march over the hashed uniform grid, and kernel M
(counterpart of `raytracercuda_tpu/trace/grid_march.py`, the reference's
``bmMarchKernelSpace``, `Raytracer/Hash.cu:235-302`).

Each ray walks cells from its origin, for at most ``max_search_iters``
steps: hash the current cell, test the bucket's first
``max_faces_per_cell`` faces in CSR order against the ORIGINAL ray (a hit
replaces the best only on a strict ``<``, so the first minimum wins), stop
at the first cell with a hit, else step through the cell by the exit
distance of `ops/math.box_ray_intersect_no_zero` plus the pinch-through
epsilon, and stop where the new point is not finite.  Like the
reference's, the march inherits the hash's collisions: a far cell that
shares the bucket can surface a genuine but not the closest hit.

Kernel M (`csrc/grid.cu:march_kernel`) runs one thread per ray over
`march_rows`, a v0 | e1 | e2 row per CSR entry built once per (grid,
scene).  `trace_grid` runs the plain PyTorch version for tensors on the
CPU and launches kernel M for tensors on a GPU; there is no fallback from
one to the other.  The plain version compacts the marching rays every
step and tests their buckets' faces ``MARCH_CHUNK`` at a time, with one
host sync a step.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..accel.grid import HashGrid, hash3_cells, map_cell
from ..config import GridConfig, TraceConfig
from ..ops.cuda_build import kernel_fn, raw_stream
from ..ops.math import box_ray_intersect_no_zero
from ..types import FLT_MAX, Hit
from .bruteforce import _mt_oracle
from .sweep import _check_cuda, _eps_args, _pick, t_eps_of
from .traverse import _rays

#: Faces of a bucket the plain version tests at once.
MARCH_CHUNK = 64

#: Kernel launches, counted where the kernel is launched.
launch_counts = {"grid_march": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


#: Kernel M's row tables: ``{id(entries): (weak references to entries,
#: cell_start, positions and faces, their versions, rows)}``; an entry
#: leaves with its grid.
_MARCH_ROWS: dict = {}


def march_rows(grid: HashGrid, positions: torch.Tensor,
               faces: torch.Tensor) -> torch.Tensor:
    """The march's triangle rows ``[E', 12]`` float32 on the grid's device,
    one per CSR entry of a bucket (``E' = cell_start[num_cells]``, at least
    one row): v0 | e1 | e2 | three zeros of the entry's face, e1 = v1 - v0
    and e2 = v2 - v0 the single subtractions of `tri_intersect`.  Built
    once per (grid, scene) and again if one of the four tensors is
    modified in place.  The pairs the build dropped (the sentinel bucket)
    get no row: no bucket's slice reaches them."""
    tensors = (grid.entries, grid.cell_start, positions, faces)
    stamp = tuple(x._version for x in tensors)
    key = id(grid.entries)
    hit = _MARCH_ROWS.get(key)
    if (hit is not None and all(r() is x for r, x in zip(hit[0], tensors))
            and hit[1] == stamp):
        return hit[2]
    n = int(grid.cell_start[grid.num_cells])
    f = faces[grid.entries[:n].long()]
    v0 = positions[f[:, 0]]
    rows = torch.cat([v0, positions[f[:, 1]] - v0, positions[f[:, 2]] - v0,
                      torch.zeros_like(v0)], dim=1)
    if n == 0:
        rows = torch.zeros((1, 12), dtype=torch.float32,
                           device=positions.device)
    rows = rows.contiguous()
    refs = (weakref.ref(grid.entries,
                        lambda _: _MARCH_ROWS.pop(key, None)),
            *(weakref.ref(x) for x in tensors[1:]))
    _MARCH_ROWS[key] = (refs, stamp, rows)
    return rows


def _row_mt(rows, o, d, t_eps):
    """The oracle's test of rays ``o``, ``d`` (``[..., 3]``) against
    `march_rows` rows (``[..., 12]``), broadcast: t/u/v."""
    cols = tuple(rows[..., c] for c in range(9))
    return _mt_oracle(cols, o[..., 0], o[..., 1], o[..., 2], d[..., 0],
                      d[..., 1], d[..., 2], t_eps)


def _tally_step(tally, rays, buckets, count, num_rays: int,
                num_cells: int) -> None:
    """Add a step of ``rays`` to ``tally`` (when given), with no host sync:
    each ray's ``ray_steps`` and ``ray_tests`` (``[num_rays]``) and the
    boolean ``touched_buckets``."""
    if tally is None:
        return
    dev = rays.device
    for name in ("ray_steps", "ray_tests"):
        tally.setdefault(name, torch.zeros(num_rays, dtype=torch.int64,
                                           device=dev))
    touched = tally.setdefault("touched_buckets", torch.zeros(
        num_cells, dtype=torch.bool, device=dev))
    tally["ray_steps"][rays] += 1
    tally["ray_tests"][rays] += torch.clamp(count, min=0)
    touched[buckets] = True


def _tally_done(tally, cell_start, max_faces: int) -> None:
    """Sum a march's ``tally``: its ``steps`` and ``tests``, and the
    ``buckets_read`` and ``rows_read`` (a visited bucket's first
    ``max_faces`` rows)."""
    if tally is None or "ray_steps" not in tally:
        return
    b = torch.nonzero(tally["touched_buckets"]).squeeze(1)
    count = torch.clamp(cell_start[b + 1].long() - cell_start[b].long(),
                        min=0, max=max_faces)
    tally.update(steps=int(tally["ray_steps"].sum()),
                 tests=int(tally["ray_tests"].sum()),
                 buckets_read=int(b.numel()), rows_read=int(count.sum()))


def _march_plain(rows, cell_start, num_cells: int, cell_res: float,
                 pinch: float, origin, direction, max_iters: int,
                 max_faces: int, t_eps, tally=None):
    """Plain version of kernel M: ``(t, u, v, slot)`` ``[R]`` for
    row-major ``[R, 3]`` rays, ``slot`` the winner's CSR entry (0 on a
    miss).  Each step compacts the rays still marching (sorted by their
    bucket's face count, so that each chunk of ``MARCH_CHUNK`` faces takes
    a prefix of them) and reads their counts in one host sync.  With a
    ``tally`` dict, counts the work (`_tally_step`, `_tally_done`)."""
    num_rays = direction.shape[0]
    dev = direction.device
    num_rows = rows.shape[0]
    # A tensor on the rays' device: a CPU scalar would make the card's
    # division a product with its reciprocal.
    res = torch.tensor(cell_res, dtype=torch.float32, device=dev)
    inv_dir = 1.0 / direction
    p = origin.clone()
    bt = torch.full((num_rays,), float(FLT_MAX), device=dev)
    bu = torch.zeros(num_rays, device=dev)
    bv = torch.zeros(num_rays, device=dev)
    bslot = torch.zeros(num_rays, dtype=torch.int64, device=dev)
    live = torch.arange(num_rays, device=dev)
    still = torch.ones(num_rays, dtype=torch.bool, device=dev)
    bases = range(0, max_faces, MARCH_CHUNK)
    for _ in range(max_iters):
        if live.numel() == 0:
            break
        cp = map_cell(p[live], res)
        h = hash3_cells(cp, num_cells)
        start = cell_start[h].long()
        count = torch.clamp(cell_start[h + 1].long() - start, max=max_faces)
        key = torch.where(still, count, -1)
        # Rays with more than ``base`` faces, for each chunk's ``base``:
        # a histogram of the chunks a ray needs, summed from the top.
        need = torch.bincount(torch.clamp(key, min=0).add_(
            MARCH_CHUNK - 1).div_(MARCH_CHUNK, rounding_mode="floor"),
            minlength=len(bases) + 1)
        per_chunk = need.flip(0).cumsum(0).flip(0)[1:len(bases) + 1]
        sizes = torch.cat([still.sum()[None], per_chunk])
        n_live, *per_chunk = sizes.tolist()  # the step's one host sync
        order = torch.argsort(key, descending=True, stable=True)[:n_live]
        live, cp, h = live[order], cp[order], h[order]
        start, count = start[order], count[order]
        _tally_step(tally, live, h, count, num_rays, num_cells)
        for base, n in zip(bases, per_chunk):
            if n == 0:
                break
            rays = live[:n]
            k = base + torch.arange(MARCH_CHUNK, device=dev)
            slots = torch.clamp(start[:n, None] + k, 0, num_rows - 1)
            t, u, v = _row_mt(rows[slots], origin[rays, None],
                              direction[rays, None], t_eps)
            t = torch.where(k < count[:n, None], t, float(FLT_MAX))
            t_blk, j = t.min(dim=1)  # the first minimum in CSR order
            closer = t_blk < bt[rays]
            jj = j[:, None]
            bt[rays] = torch.where(closer, t_blk, bt[rays])
            bu[rays] = torch.where(closer, u.gather(1, jj)[:, 0], bu[rays])
            bv[rays] = torch.where(closer, v.gather(1, jj)[:, 0], bv[rays])
            bslot[rays] = torch.where(closer, slots.gather(1, jj)[:, 0],
                                      bslot[rays])
        # Step the rays without a hit through their cell.
        pl = p[live]
        bmin = cp.to(torch.float32) * res
        box_d = box_ray_intersect_no_zero(bmin, bmin + res, pl,
                                          inv_dir[live])
        p_new = pl + direction[live] * (box_d + pinch)[:, None]
        still = (bt[live] == float(FLT_MAX)) & torch.isfinite(p_new).all(-1)
        p[live] = torch.where(still[:, None], p_new, pl)
    _tally_done(tally, cell_start, max_faces)
    return bt, bu, bv, bslot.to(torch.int32)


def _march_cuda(rows, cell_start, num_cells: int, cell_res: float,
                pinch: float, origin, direction, max_iters: int,
                max_faces: int, t_eps):
    """Launch kernel M; outputs as in `_march_plain`."""
    num_rays = direction.shape[0]
    dev = direction.device
    _check_cuda("origin", origin, dev, torch.float32, (num_rays, 3))
    _check_cuda("direction", direction, dev, torch.float32, (num_rays, 3))
    _check_cuda("cell_start", cell_start, dev, torch.int32,
                (num_cells + 1,))
    _check_cuda("rows", rows, dev, torch.float32, (rows.shape[0], 12))
    out = torch.empty((3, num_rays), dtype=torch.float32, device=dev)
    slot = torch.empty(num_rays, dtype=torch.int32, device=dev)
    err = kernel_fn("rt_grid_march")(
        cell_start.data_ptr(), num_cells, rows.data_ptr(), rows.shape[0],
        origin.data_ptr(), direction.data_ptr(), num_rays, float(cell_res),
        float(pinch), max_iters, max_faces, *_eps_args(t_eps),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        slot.data_ptr(), raw_stream(dev))
    if err:
        raise RuntimeError(f"kernel M launch failed: CUDA error {err}")
    launch_counts["grid_march"] += 1
    return out[0], out[1], out[2], slot


def march_args(grid: HashGrid, positions, faces, origin, direction,
               cfg: GridConfig, trace_cfg: TraceConfig) -> tuple:
    """The arguments of `_march_plain` and `_march_cuda` for `trace_grid`'s
    inputs (``origin`` ``[R, 3]`` or ``[3]``)."""
    origin, direction = _rays(origin, direction)
    res = np.float32(grid.cell_res.item())
    pinch = res * np.float32(cfg.pinch_epsilon_frac)
    return (march_rows(grid, positions, faces), grid.cell_start,
            grid.num_cells, float(res), float(pinch), origin, direction,
            cfg.max_search_iters, cfg.max_faces_per_cell,
            t_eps_of(trace_cfg))


def slot_hit(grid: HashGrid, t, u, v, slot) -> Hit:
    """A `Hit` from the march's best (t, u, v, slot): the face is the
    entry's, ``entries[slot]``, where ``t < FLT_MAX``, else -1."""
    face = torch.where(t == float(FLT_MAX), -1,
                       grid.entries[slot.long()].to(torch.int32))
    return Hit(t=t, u=u, v=v, face=face.to(torch.int32))


def trace_grid(
    grid: HashGrid,
    positions: torch.Tensor,
    faces: torch.Tensor,
    origin: torch.Tensor,
    direction: torch.Tensor,
    cfg: GridConfig = GridConfig(),
    trace_cfg: TraceConfig = TraceConfig(),
) -> Hit:
    """Closest hit, as the march finds it, for ``[R, 3]`` rays over the hash
    grid of ``positions``/``faces``; ``origin`` is ``[R, 3]`` or ``[3]``."""
    args = march_args(grid, positions, faces, origin, direction, cfg,
                      trace_cfg)
    run = _pick(args[6], _march_plain, _march_cuda)
    return slot_hit(grid, *run(*args))
