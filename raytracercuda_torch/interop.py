"""Scene state carried across from the JAX package.

The JAX package's `SceneData` and `ClusterSet` hold jax arrays; their
fields converted to numpy (``np.asarray``) become the port's tensors
here, on any device.  Integer index tables widen to int64, the port's
index type.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel.clusters import ClusterSet, edge_rows
from .models.scene import SceneData


def _tensor(x, device, dtype=None) -> torch.Tensor:
    # np.array copies: the source may be a read-only view of a jax array.
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def scene_from_numpy(positions, faces, attrs, mesh_material, albedo,
                     texture_id, textures, reflectivity=None, *,
                     device: torch.device | str = "cpu") -> SceneData:
    """A port `SceneData` from the fields of a JAX `SceneData` (or any
    array-likes of the same shapes)."""
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
                           device: torch.device | str = "cpu") -> ClusterSet:
    """A port `ClusterSet` from a JAX `ClusterSet`'s cluster boxes, sorted
    triangles, slot -> face table and (when it has one) face -> slot
    table.  The geometry rows of kernels C and H are derived here."""
    tris = _tensor(tris, device, np.float32)
    return ClusterSet(cmin=_tensor(cmin, device, np.float32),
                      cmax=_tensor(cmax, device, np.float32),
                      tris=tris,
                      face_order=_tensor(face_order, device, np.int64),
                      tri_blocks=edge_rows(tris).contiguous(),
                      face_rank=None if face_rank is None
                      else _tensor(face_rank, device, np.int64))
