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

Kernel M (`csrc/grid.cu:march_kernel`) marches a block's 32 rays together:
at each step the rays that share a bucket read its rows once, 32 at a
time, one a lane, over `march_rows` (a v0 | e1 | e2 row per CSR entry,
built once per (grid, scene)), the rounds dealt to the block's two warps.
Two optional hints, which never change the result: ``frame_hw`` makes the
32 rays an 8x4 pixel patch of a row-major frame (neighbouring pixels share
more buckets), and ``common_origin`` (every ray leaves it; checked) lets
the test read `eye_rows`, the triangles' eye terms staged once per (grid,
scene, eye).  `trace_grid` runs the plain PyTorch version for tensors on
the CPU and launches kernel M for tensors on a GPU; there is no fallback
from one to the other.  The plain version ignores the hints; it compacts the
marching rays every step and tests their buckets' faces ``MARCH_CHUNK`` at
a time, with one host sync a step.
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
from .sweep import _check_cuda, _eps_args, _eye_rows_plain, _pick, t_eps_of
from .traverse import _rays

#: Faces of a bucket the plain version tests at once.
MARCH_CHUNK = 64

#: Kernel M's 32 rays of a block on a frame: a patch of PATCH_W columns by
#: PATCH_H rows.
PATCH_W, PATCH_H = 8, 4

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


#: The staged eye terms: ``{id(rows): (a weak reference to rows, the
#: eye's bits, table)}``; an entry leaves with its rows.
_EYE_ROWS: dict = {}


def eye_rows(rows: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """Kernel M's rows for rays that all leave ``eye`` (``[3]``): ``[E',
    16]`` float32 on the rows' device, one per `march_rows` row, e1 | e2 |
    tvec | qvec | tq | three zeros, with tvec = eye - v0, qvec = tvec x e1
    and tq = e2 . qvec (summed left to right): the terms of the oracle's
    test that depend on the triangle and the origin alone, each product
    and sum rounded once, in the oracle's order (`csrc/mt.cuh:oracle_mt`),
    so a test that reads them gives its t, u and v bit for bit.  Built
    once per (``rows``, the eye's float32 bits), whatever tensor holds the
    eye; ``rows`` is itself rebuilt, as a new tensor, with its grid or
    scene."""
    e = eye.to(device=rows.device, dtype=torch.float32)
    bits = tuple(e.view(torch.int32).tolist())
    key = id(rows)
    hit = _EYE_ROWS.get(key)
    if hit is not None and hit[0]() is rows and hit[1] == bits:
        return hit[2]
    table = _eye_rows_plain(e, rows).contiguous()
    _EYE_ROWS[key] = (weakref.ref(rows, lambda _: _EYE_ROWS.pop(key, None)),
                      bits, table)
    return table


def num_blocks(num_rays: int, frame_hw=None) -> int:
    """Kernel M's blocks for ``num_rays`` rays (`block_of_rays`)."""
    if frame_hw is None:
        return -(-num_rays // 32)
    return -(-frame_hw[0] // PATCH_H) * -(-frame_hw[1] // PATCH_W)


def block_of_rays(num_rays: int, frame_hw=None,
                  device=None) -> torch.Tensor:
    """Kernel M's block of each ray, ``[num_rays]`` int64: 32 consecutive
    rays a block, or with ``frame_hw`` ``(H, W)`` (row-major rays) the
    ``PATCH_W`` x ``PATCH_H`` pixel patch, patches row-major."""
    i = torch.arange(num_rays, device=device)
    if frame_hw is None:
        return i // 32
    width = frame_hw[1]
    y, x = i // width, i % width
    return (y // PATCH_H) * -(-width // PATCH_W) + x // PATCH_W


def _row_mt(rows, o, d, t_eps):
    """The oracle's test of rays ``o``, ``d`` (``[..., 3]``) against
    `march_rows` rows (``[..., 12]``), broadcast: t/u/v."""
    cols = tuple(rows[..., c] for c in range(9))
    return _mt_oracle(cols, o[..., 0], o[..., 1], o[..., 2], d[..., 0],
                      d[..., 1], d[..., 2], t_eps)


def _tally_step(tally, rays, buckets, count, num_rays: int,
                num_cells: int, frame_hw=None) -> None:
    """Add a step of the marching ``rays`` to ``tally`` (when given), with
    no host sync: each ray's ``ray_steps`` and ``ray_tests``
    (``[num_rays]``), the boolean ``touched_buckets``, and the work of
    kernel M's blocks of 32 rays (`block_of_rays`: ``"row"``, and
    ``"patch"`` with ``frame_hw``) under two schedules.  With one thread a
    ray, a warp's step lasts its largest bucket (``serial_rounds``); a
    block that reads each distinct bucket once (``shared_rows``) tests it
    in rounds of 32 rows for each of its rays (``shared_rounds``, the same
    for either shape)."""
    if tally is None:
        return
    dev = rays.device
    for name in ("ray_steps", "ray_tests"):
        tally.setdefault(name, torch.zeros(num_rays, dtype=torch.int64,
                                           device=dev))
    touched = tally.setdefault("touched_buckets", torch.zeros(
        num_cells, dtype=torch.bool, device=dev))
    c = torch.clamp(count, min=0)
    tally["ray_steps"][rays] += 1
    tally["ray_tests"][rays] += c
    touched[buckets] = True
    if "blocks" not in tally:
        shapes = {"row": None, **({} if frame_hw is None
                                  else {"patch": tuple(frame_hw)})}
        tally["blocks"] = {k: (block_of_rays(num_rays, hw, dev),
                               num_blocks(num_rays, hw))
                           for k, hw in shapes.items()}
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        tally["shared_rounds"] = zero.clone()
        tally["serial_rounds"] = {k: zero.clone() for k in shapes}
        tally["shared_rows"] = {k: zero.clone() for k in shapes}
    tally["shared_rounds"] += (c + 31).div(32, rounding_mode="floor").sum()
    for name, (blocks, n_blocks) in tally["blocks"].items():
        b = blocks[rays]
        longest = torch.zeros(n_blocks, dtype=torch.int64, device=dev)
        longest.scatter_reduce_(0, b, c, "amax")
        tally["serial_rounds"][name] += longest.sum()
        keys, order = torch.sort(b * num_cells + buckets)
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        tally["shared_rows"][name] += (c[order] * first).sum()


def _tally_done(tally, cell_start, max_faces: int) -> None:
    """Sum a march's ``tally``: its ``steps`` and ``tests``, the
    ``buckets_read`` and ``rows_read`` (a visited bucket's first
    ``max_faces`` rows), and, for each block shape, the share of test
    slots that do work with one thread a ray (``serial_lane_use``: tests
    over 32 x ``serial_rounds``) and the rows a block's step reads when it
    reads each distinct bucket once (``shared_rows``, against ``tests``
    read by ray); ``shared_lane_use``, tests over 32 x
    ``shared_rounds``."""
    if tally is None or "ray_steps" not in tally:
        return
    b = torch.nonzero(tally["touched_buckets"]).squeeze(1)
    count = torch.clamp(cell_start[b + 1].long() - cell_start[b].long(),
                        min=0, max=max_faces)
    tests = int(tally["ray_tests"].sum())

    def use(rounds):
        rounds = int(rounds)
        return tests / (32 * rounds) if rounds else 0.0

    tally.update(steps=int(tally["ray_steps"].sum()), tests=tests,
                 buckets_read=int(b.numel()), rows_read=int(count.sum()),
                 serial_lane_use={k: use(v) for k, v in
                                  tally["serial_rounds"].items()},
                 shared_lane_use=use(tally["shared_rounds"]),
                 shared_rows={k: int(v) for k, v in
                              tally["shared_rows"].items()})


def _march_plain(rows, cell_start, num_cells: int, cell_res: float,
                 pinch: float, origin, direction, max_iters: int,
                 max_faces: int, t_eps, frame_hw=None, common_origin=None,
                 tally=None):
    """Plain version of kernel M: ``(t, u, v, slot)`` ``[R]`` for
    row-major ``[R, 3]`` rays, ``slot`` the winner's CSR entry (0 on a
    miss).  Each step compacts the rays still marching (sorted by their
    bucket's face count, so that each chunk of ``MARCH_CHUNK`` faces takes
    a prefix of them) and reads their counts in one host sync.  The hints
    ``frame_hw`` and ``common_origin`` change nothing here.  With a
    ``tally`` dict, counts the work (`_tally_step`, `_tally_done`; its
    pixel patches from ``frame_hw``)."""
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
        _tally_step(tally, live, h, count, num_rays, num_cells, frame_hw)
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
                max_faces: int, t_eps, frame_hw=None, common_origin=None):
    """Launch kernel M; outputs as in `_march_plain`.  With
    ``common_origin`` (every ray's origin, as `march_args` checks) the
    kernel marches from it and reads `eye_rows`; with ``frame_hw`` a
    block's 32 rays are a pixel patch."""
    num_rays = direction.shape[0]
    dev = direction.device
    _check_cuda("origin", origin, dev, torch.float32, (num_rays, 3))
    _check_cuda("direction", direction, dev, torch.float32, (num_rays, 3))
    _check_cuda("cell_start", cell_start, dev, torch.int32,
                (num_cells + 1,))
    _check_cuda("rows", rows, dev, torch.float32, (rows.shape[0], 12))
    height, width = (0, 0) if frame_hw is None else frame_hw
    if frame_hw is not None and height * width != num_rays:
        raise ValueError(f"frame_hw {tuple(frame_hw)} does not hold "
                         f"{num_rays} rays")
    staged, source, stride = 0, origin, 3
    if common_origin is not None:
        _check_cuda("common_origin", common_origin, dev, torch.float32,
                    (3,))
        table = eye_rows(rows, common_origin)
        staged, source, stride = table.data_ptr(), common_origin, 0
    out = torch.empty((3, num_rays), dtype=torch.float32, device=dev)
    slot = torch.empty(num_rays, dtype=torch.int32, device=dev)
    err = kernel_fn("rt_grid_march")(
        cell_start.data_ptr(), num_cells, rows.data_ptr(), staged,
        rows.shape[0], source.data_ptr(), stride, direction.data_ptr(),
        num_rays, height, width, float(cell_res), float(pinch), max_iters,
        max_faces, *_eps_args(t_eps), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), slot.data_ptr(),
        raw_stream(dev))
    if err:
        raise RuntimeError(f"kernel M launch failed: CUDA error {err}")
    launch_counts["grid_march"] += 1
    return out[0], out[1], out[2], slot


def march_args(grid: HashGrid, positions, faces, origin, direction,
               cfg: GridConfig, trace_cfg: TraceConfig, frame_hw=None,
               common_origin=None) -> tuple:
    """The arguments of `_march_plain` and `_march_cuda` for `trace_grid`'s
    inputs (``origin`` ``[R, 3]`` or ``[3]``), the hints last: ``frame_hw``
    ``(H, W)`` with H x W = R, and ``common_origin`` ``[3]`` float32 on the
    rays' device.  Raises ValueError where a hint does not hold, on either
    device: ``common_origin`` must equal every origin bit for bit (one host
    sync)."""
    origin, direction = _rays(origin, direction)
    num_rays = direction.shape[0]
    if frame_hw is not None:
        frame_hw = (int(frame_hw[0]), int(frame_hw[1]))
        if frame_hw[0] * frame_hw[1] != num_rays:
            raise ValueError(f"frame_hw {frame_hw} does not hold {num_rays} "
                             "rays")
    if common_origin is not None:
        common_origin = common_origin.to(device=direction.device,
                                         dtype=torch.float32).contiguous()
        if tuple(common_origin.shape) != (3,) or not torch.equal(
                origin.view(torch.int32),
                common_origin.view(torch.int32).expand(origin.shape)):
            raise ValueError("common_origin is not every ray's origin")
    res = np.float32(grid.cell_res.item())
    pinch = res * np.float32(cfg.pinch_epsilon_frac)
    return (march_rows(grid, positions, faces), grid.cell_start,
            grid.num_cells, float(res), float(pinch), origin, direction,
            cfg.max_search_iters, cfg.max_faces_per_cell,
            t_eps_of(trace_cfg), frame_hw, common_origin)


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
    *,
    frame_hw: tuple[int, int] | None = None,
    common_origin: torch.Tensor | None = None,
) -> Hit:
    """Closest hit, as the march finds it, for ``[R, 3]`` rays over the hash
    grid of ``positions``/``faces``; ``origin`` is ``[R, 3]`` or ``[3]``.
    Hints for kernel M, which leave the `Hit` as it is: ``frame_hw`` ``(H,
    W)`` when the rays are a row-major frame, ``common_origin`` ``[3]``
    when every ray leaves it; ValueError where a hint does not hold."""
    args = march_args(grid, positions, faces, origin, direction, cfg,
                      trace_cfg, frame_hw, common_origin)
    run = _pick(args[6], _march_plain, _march_cuda)
    return slot_hit(grid, *run(*args))
