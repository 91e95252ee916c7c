"""Morton-ordered triangle clusters (counterpart of
`raytracercuda_tpu/accel/clusters.py:45-146`).

Triangles are sorted by the Morton code of their AABB centre with a stable
sort and cut into clusters of ``cluster_size`` consecutive triangles.  The
order decides slot ids, which decide ties between equal hits, so it must
match the JAX package exactly.  The matrix-form constants of the TPU's
dense sweep (`origin_consts`/`direction_consts`) are not part of the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ClusterConfig
from .bvh import morton_codes


class ClusterSet(NamedTuple):
    """Flat cluster table: ``C`` clusters of ``L`` Morton-consecutive
    triangles; the last cluster is padded with all-zero triangles."""

    #: [C,3] / [C,3] cluster AABBs (from the real triangles only).
    cmin: torch.Tensor
    cmax: torch.Tensor
    #: [C, L, 9] float32 — v0 | v1 | v2 per sorted triangle (zero padding).
    tris: torch.Tensor
    #: [C*L] int64 — original face id per sorted slot (-1 for padding).
    face_order: torch.Tensor
    #: [C, L, 9] float32 or None — v0 | e1 | e2 rows (e = v - v0), the
    #: geometry operand of every tile sweep (`sweep.segment_blocks`),
    #: cached at build time so frames never rebuild it.
    tri_blocks: Optional[torch.Tensor] = None
    #: [F] int64 or None — inverse of ``face_order``: original face id ->
    #: sorted slot.  The differentiable route builds its row table in slot
    #: order with it (`diff/render_grad._rows_recompute_shade`).
    face_rank: Optional[torch.Tensor] = None

    @property
    def num_clusters(self) -> int:
        return self.cmin.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.tris.shape[1]


def edge_rows(tris: torch.Tensor) -> torch.Tensor:
    """``[..., 9]`` v0 | v1 | v2 -> v0 | v1 - v0 | v2 - v0, the same float32
    subtractions the JAX package's `segment_blocks` makes."""
    v0 = tris[..., 0:3]
    return torch.cat([v0, tris[..., 3:6] - v0, tris[..., 6:9] - v0], dim=-1)


def build_clusters(positions: torch.Tensor, faces: torch.Tensor,
                   cfg: ClusterConfig = ClusterConfig()) -> ClusterSet:
    """Sort triangles in Morton order and cut them into fixed clusters.

    ``positions`` ``[V,3]`` float32, ``faces`` ``[F,4]`` integer (3 vertex
    ids + mesh id), both on the device the clusters should live on."""
    L = cfg.cluster_size
    faces = faces.long()
    num_faces = faces.shape[0]
    v0 = positions[faces[:, 0]]
    v1 = positions[faces[:, 1]]
    v2 = positions[faces[:, 2]]
    tri_min = torch.minimum(v0, torch.minimum(v1, v2))
    tri_max = torch.maximum(v0, torch.maximum(v1, v2))
    centroids = (tri_min + tri_max) * 0.5
    smin = tri_min.amin(dim=0)
    smax = tri_max.amax(dim=0)

    codes = morton_codes(centroids, smin, smax, cfg.morton_bits)
    order = torch.argsort(codes, stable=True)

    num_clusters = -(-num_faces // L)
    pad = num_clusters * L - num_faces

    def padded(x, fill):
        tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail])

    face_order = padded(order, -1)
    tris = torch.cat([padded(v[order], 0.0) for v in (v0, v1, v2)], dim=-1)
    cmin = padded(tri_min[order], float("inf")).reshape(
        num_clusters, L, 3).amin(dim=1)
    cmax = padded(tri_max[order], float("-inf")).reshape(
        num_clusters, L, 3).amax(dim=1)
    tris = tris.reshape(num_clusters, L, 9)
    face_rank = torch.empty_like(order)
    face_rank[order] = torch.arange(num_faces, device=order.device)
    return ClusterSet(cmin=cmin, cmax=cmax, tris=tris, face_order=face_order,
                      tri_blocks=edge_rows(tris).contiguous(),
                      face_rank=face_rank)
