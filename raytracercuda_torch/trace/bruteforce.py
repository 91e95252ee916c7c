"""Brute-force (all-pairs) closest hit: the correctness oracle, and kernel E
(counterpart of `raytracercuda_tpu/trace/bruteforce.py` and
`trace/pallas_brute.py`).

Every ray is tested against every triangle.  The rules are the oracle's
(`bruteforce.py:32-115`), not the tile sweeps':

  * Möller–Trumbore in `ops/math.tri_intersect`'s term order;
  * a triangle misses when u, v or t is NaN or on the u/v window tests
    (the NaN rule, no ``|det|`` threshold); with ``clip_backward_hits``,
    ``t < t_epsilon`` becomes ``FLT_MAX``;
  * the winner is the first minimum in face order;
  * a miss carries ``face = -1``, ``u = v = 0`` and ``t = FLT_MAX``.

Kernel E (`csrc/brute.cu`, replacing `pallas_brute._mt_kernel`) splits
the work over a grid of ray groups by face chunks: each thread of
`brute_items_kernel` holds ``BRUTE_RAYS_PER_THREAD`` rays and tests them
against the ``BRUTE_FACE_CHUNK`` faces of its block, each block merges its
rays' closest hits with a 64-bit ``atomicMin`` on (ordered t, face), and
`brute_epilogue_kernel` re-runs the oracle formula on each winner.
`trace_brute` runs the plain PyTorch version for tensors on the CPU and
launches kernel E for tensors on a GPU; there is no fallback from one to
the other.
"""

from __future__ import annotations

import torch

from ..config import TraceConfig
from ..types import FLT_MAX, Hit
from ..ops.cuda_build import kernel_fn, raw_stream
from .sweep import _check_cuda, _eps_args, _pick, t_eps_of

#: Kernel launches, counted where the kernel is launched.
launch_counts = {"brute": 0}

#: Kernel E's rays per thread (P: 1, 2, 4 or 8) and faces per block (its
#: face chunk): the fastest, within the run's spread, of `chip_smoke.py`'s
#: sweep over both on config 2 on the H100 (PERF.md).
BRUTE_RAYS_PER_THREAD = 4
BRUTE_FACE_CHUNK = 512

#: Rays and faces the plain version tests at once: its ``[rays, faces]``
#: temporaries stay at 16 MB each.
_PLAIN_RAYS = 2048
_PLAIN_FACES = 2048


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def face_columns(positions: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """``[9, F]`` float32 v0 | e1 | e2 components per face (e = v - v0,
    the float32 subtractions `tri_intersect` makes per pair)."""
    f = faces.long()
    v0 = positions[f[:, 0]]
    e1 = positions[f[:, 1]] - v0
    e2 = positions[f[:, 2]] - v0
    return torch.cat([v0, e1, e2], dim=1).T.contiguous()


def _mt_oracle(tri, ox, oy, oz, dx, dy, dz, t_eps):
    """Möller–Trumbore with faces on the last dim (``[1, F]`` columns) and
    rays on the first (``[R, 1]``) -> t/u/v ``[R, F]``: `tri_intersect`'s
    terms with each sum written out left to right, the NaN miss rule."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = 1.0 / det
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
    miss = miss | torch.isnan(u) | torch.isnan(v) | torch.isnan(t)
    t = torch.where(miss, float(FLT_MAX), t)
    if t_eps is not None:
        t = torch.where(t < t_eps, float(FLT_MAX), t)
    return t, u, v


def _brute_plain(origin, direction, tris, t_eps):
    """Plain version of kernel E: ``(t, u, v, face)`` ``[R]`` for row-major
    ``[R, 3]`` rays over ``[9, F]`` face columns; rays and faces in chunks,
    first minimum within a face chunk, strict ``<`` across chunks."""
    num_rays, num_faces = direction.shape[0], tris.shape[1]
    dev = direction.device
    bt = torch.full((num_rays,), float(FLT_MAX), device=dev)
    bu = torch.zeros(num_rays, device=dev)
    bv = torch.zeros(num_rays, device=dev)
    bf = torch.full((num_rays,), -1, dtype=torch.int32, device=dev)
    for r0 in range(0, num_rays, _PLAIN_RAYS):
        rs = slice(r0, r0 + _PLAIN_RAYS)
        o = origin[rs, :, None]  # [n,3,1]
        d = direction[rs, :, None]
        for f0 in range(0, num_faces, _PLAIN_FACES):
            tri = tuple(tris[k:k + 1, f0:f0 + _PLAIN_FACES] for k in range(9))
            t, u, v = _mt_oracle(tri, o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                                 d[:, 1], d[:, 2], t_eps)
            t_blk, j = t.min(dim=1)  # first minimum over the chunk's faces
            better = t_blk < bt[rs]
            jj = j[:, None]
            bt[rs] = torch.where(better, t_blk, bt[rs])
            bu[rs] = torch.where(better, u.gather(1, jj)[:, 0], bu[rs])
            bv[rs] = torch.where(better, v.gather(1, jj)[:, 0], bv[rs])
            bf[rs] = torch.where(better, (j + f0).to(torch.int32), bf[rs])
    return bt, bu, bv, bf


def _brute_cuda(origin, direction, tris, t_eps):
    """Launch kernel E; outputs as in `_brute_plain`."""
    num_rays, num_faces = direction.shape[0], tris.shape[1]
    dev = direction.device
    _check_cuda("origin", origin, dev, torch.float32, (num_rays, 3))
    _check_cuda("direction", direction, dev, torch.float32, (num_rays, 3))
    _check_cuda("tris", tris, dev, torch.float32, (9, num_faces))
    keys = torch.empty(num_rays, dtype=torch.int64, device=dev)
    out = torch.empty((3, num_rays), dtype=torch.float32, device=dev)
    face = torch.empty(num_rays, dtype=torch.int32, device=dev)
    err = kernel_fn("rt_brute")(
        origin.data_ptr(), direction.data_ptr(), tris.data_ptr(), num_rays,
        num_faces, *_eps_args(t_eps), BRUTE_RAYS_PER_THREAD,
        BRUTE_FACE_CHUNK, keys.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), face.data_ptr(),
        raw_stream(dev))
    if err:
        raise RuntimeError(f"kernel E launch failed: CUDA error {err}")
    launch_counts["brute"] += 1
    return out[0], out[1], out[2], face


def trace_brute(
    positions: torch.Tensor,
    faces: torch.Tensor,
    origin: torch.Tensor,
    direction: torch.Tensor,
    cfg: TraceConfig = TraceConfig(),
) -> Hit:
    """Closest hit of each ray against all faces -> `Hit` ``[R]``.

    ``positions [V, 3]`` float32, ``faces [F, 4]`` (3 vertex ids + mesh
    id), ``direction [R, 3]``, ``origin [R, 3]`` or ``[3]`` (shared)."""
    direction = direction.to(torch.float32).contiguous()
    origin = origin.to(torch.float32).expand(direction.shape).contiguous()
    run = _pick(direction, _brute_plain, _brute_cuda)
    t, u, v, face = run(origin, direction, face_columns(positions, faces),
                        t_eps_of(cfg))
    return Hit(t=t, u=u, v=v, face=face)


def any_hit_brute(
    positions: torch.Tensor,
    faces: torch.Tensor,
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_max: torch.Tensor,
    cfg: TraceConfig = TraceConfig(),
) -> torch.Tensor:
    """Occlusion for shadow rays: True where a face is hit with
    ``t_epsilon < t < t_max`` (`bruteforce.py:118-130`)."""
    hit = trace_brute(positions, faces, origin, direction, cfg)
    return (hit.t > cfg.t_epsilon) & (hit.t < t_max)
