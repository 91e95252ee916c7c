"""Scene state carried across from the JAX package.

The JAX package's `SceneData`, `ClusterSet`, `Bvh`, `HashGrid` and
`ShadowGrid` hold jax arrays; their fields converted to numpy
(``np.asarray``) become the port's tensors here, on any device.  Integer
index tables widen to int64, the port's index type, except where the
port's own structures keep int32 (the LBVH's packed links, the grids' CSR
tables).  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel.bvh import Bvh
from .accel.clusters import ClusterSet, edge_rows
from .accel.grid import HashGrid
from .device import resolve_device
from .models.scene import SceneData
from .trace.shadow import ShadowGrid


def _tensor(x, device, dtype=None) -> torch.Tensor:
    # np.array copies: the source may be a read-only view of a jax array.
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def scene_from_numpy(positions, faces, attrs, mesh_material, albedo,
                     texture_id, textures, reflectivity=None, *,
                     device: torch.device | str | None = None) -> SceneData:
    """A port `SceneData` from the fields of a JAX `SceneData` (or any
    array-likes of the same shapes), on ``device`` (the card when None)."""
    device = resolve_device(device)
    return SceneData(
        positions=_tensor(positions, device, np.float32),
        faces=_tensor(faces, device, np.int64),
        attrs={int(k): _tensor(v, device, np.float32)
               for k, v in attrs.items()},
        mesh_material=_tensor(mesh_material, device, np.int64),
        albedo=_tensor(albedo, device, np.float32),
        texture_id=_tensor(texture_id, device, np.int32),
        textures=_tensor(textures, device, np.float32),
        reflectivity=None if reflectivity is None
        else _tensor(reflectivity, device, np.float32),
    )


def cluster_set_from_numpy(cmin, cmax, tris, face_order, face_rank=None, *,
                           device: torch.device | str | None = None
                           ) -> ClusterSet:
    """A port `ClusterSet` from a JAX `ClusterSet`'s cluster boxes, sorted
    triangles, slot -> face table and (when it has one) face -> slot
    table, on ``device`` (the card when None).  The geometry rows of the
    tile sweeps are derived here."""
    device = resolve_device(device)
    tris = _tensor(tris, device, np.float32)
    return ClusterSet(cmin=_tensor(cmin, device, np.float32),
                      cmax=_tensor(cmax, device, np.float32),
                      tris=tris,
                      face_order=_tensor(face_order, device, np.int64),
                      tri_blocks=edge_rows(tris).contiguous(),
                      face_rank=None if face_rank is None
                      else _tensor(face_rank, device, np.int64))


def bvh_from_numpy(node_min, node_max, hit_link, skip_link, is_leaf,
                   leaf_first, leaf_count, face_order, packed_nodes,
                   packed_links, packed_tris, *,
                   device: torch.device | str | None = None) -> Bvh:
    """A port `Bvh` from the fields of a JAX `Bvh` (``Bvh(**{k:
    np.asarray(v) ...})``), on ``device`` (the card when None): index
    tables int64, ``packed_links`` int32, boxes and triangles float32."""
    device = resolve_device(device)
    return Bvh(node_min=_tensor(node_min, device, np.float32),
               node_max=_tensor(node_max, device, np.float32),
               hit_link=_tensor(hit_link, device, np.int64),
               skip_link=_tensor(skip_link, device, np.int64),
               is_leaf=_tensor(is_leaf, device, np.bool_),
               leaf_first=_tensor(leaf_first, device, np.int64),
               leaf_count=_tensor(leaf_count, device, np.int64),
               face_order=_tensor(face_order, device, np.int64),
               packed_nodes=_tensor(packed_nodes, device, np.float32),
               packed_links=_tensor(packed_links, device, np.int32),
               packed_tris=_tensor(packed_tris, device, np.float32))


def hash_grid_from_numpy(cell_start, entries, cell_res, num_cells: int, *,
                         device: torch.device | str | None = None
                         ) -> HashGrid:
    """A port `HashGrid` from a JAX `HashGrid`'s CSR offsets, entries and
    cell size, on ``device`` (the card when None): both tables int32."""
    device = resolve_device(device)
    return HashGrid(cell_start=_tensor(cell_start, device, np.int32),
                    entries=_tensor(entries, device, np.int32),
                    cell_res=_tensor(cell_res, device, np.float32),
                    num_cells=int(num_cells))


def shadow_grid_from_numpy(u_axis, v_axis, l_axis, uv_min, inv_cell,
                           cell_start, entry_tris, res: int, *,
                           device: torch.device | str | None = None
                           ) -> ShadowGrid:
    """A port `ShadowGrid` from the fields of a JAX `ShadowGrid`, on
    ``device`` (the card when None)."""
    device = resolve_device(device)
    return ShadowGrid(u_axis=_tensor(u_axis, device, np.float32),
                      v_axis=_tensor(v_axis, device, np.float32),
                      l_axis=_tensor(l_axis, device, np.float32),
                      uv_min=_tensor(uv_min, device, np.float32),
                      inv_cell=_tensor(inv_cell, device, np.float32),
                      cell_start=_tensor(cell_start, device, np.int32),
                      entry_tris=_tensor(entry_tris, device, np.float32),
                      res=int(res))
