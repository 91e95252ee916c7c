"""Scene: mesh aggregation into flat tensors on one device, and the public
API's ``march`` (counterpart of `raytracercuda_tpu/models/scene.py`).

Every mesh is concatenated into single SoA tensors with a global face
table, rows ``(i0, i1, i2, mesh_id)``.  The `Scene` builds the LBVH for
BVH and WAVEFRONT (the default structure), the cluster set for CLUSTER,
the hash grid for GRID, or none for BRUTE.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import AccelKind, DEFAULT_CONFIG, RenderConfig
from ..device import resolve_device
from ..errors import (
    ERROR_ALL_FINE,
    ERROR_NO_RENDER_TARGET,
    ERROR_RT_CAM_MISMATCH,
)
from .mesh import Mesh, VERTEX_DATA_COUNT, VERTEX_DATA_POSITION


class SceneData(NamedTuple):
    """Flattened scene as SoA tensors on one device."""

    positions: torch.Tensor  # [V,3] float32
    faces: torch.Tensor  # [F,4] int64
    attrs: dict  # {slot_id: [V,k] float32} concatenated, zero-filled
    mesh_material: torch.Tensor  # [num_meshes] int64 material id
    albedo: torch.Tensor  # [M,3] float32 material base color
    texture_id: torch.Tensor  # [M] int32 index into textures, -1 = none
    textures: torch.Tensor  # [T,H,W,3] float32 texture atlas
    #: [M] float32 mirror reflectance (None == all 0).
    reflectivity: Optional[torch.Tensor] = None

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def face_vertices(self, face_ids):
        """The three corner positions of ``face_ids``: three ``[..., 3]``
        tensors."""
        f = self.faces[face_ids]
        return (self.positions[f[..., 0]], self.positions[f[..., 1]],
                self.positions[f[..., 2]])

    def aabb(self):
        """The scene's box: per-axis min and max of the positions."""
        return self.positions.amin(dim=0), self.positions.amax(dim=0)


class Material:
    """Host-side material: base colour, texture id, reflectivity."""

    def __init__(self, albedo=(1.0, 1.0, 1.0), texture_id: int = -1,
                 reflectivity: float = 0.0):
        self.albedo = tuple(float(c) for c in albedo)
        self.texture_id = texture_id
        self.reflectivity = float(reflectivity)


def flatten_meshes(
    meshes: list[Mesh],
    materials: Optional[list[Material]] = None,
    textures: Optional[list[np.ndarray]] = None,
    device: torch.device | str | None = None,
) -> SceneData:
    """Concatenate meshes into one SoA scene on ``device`` (the card when
    None)."""
    device = resolve_device(device)
    if not meshes:
        raise ValueError("scene has no meshes")
    if materials is None:
        materials = [Material()]

    pos_list, face_list = [], []
    voffset = 0
    # Per-slot widths: max across meshes; missing slots zero-fill.
    slot_sizes = [0] * VERTEX_DATA_COUNT
    for m in meshes:
        for s in range(VERTEX_DATA_COUNT):
            slot_sizes[s] = max(slot_sizes[s], m.vertex_data_size(s))

    attr_lists: dict[int, list[np.ndarray]] = {
        s: [] for s in range(VERTEX_DATA_COUNT)
        if slot_sizes[s] > 0 and s != VERTEX_DATA_POSITION
    }
    mesh_material = []
    for mesh_id, m in enumerate(meshes):
        if m.indices is None:
            raise ValueError("mesh has no indices")
        nv = m.num_vertices
        pos_list.append(m.positions.astype(np.float32))
        idx = m.indices.reshape(-1, 3).astype(np.int64) + voffset
        mid = np.full((idx.shape[0], 1), mesh_id, dtype=np.int64)
        face_list.append(np.concatenate([idx, mid], axis=1))
        for s, lst in attr_lists.items():
            data = m.vertex_data(s)
            width = slot_sizes[s]
            if data is None:
                lst.append(np.zeros((nv, width), np.float32))
            elif data.shape[1] < width:
                pad = np.zeros((nv, width - data.shape[1]), np.float32)
                lst.append(np.concatenate([data, pad], axis=1))
            else:
                lst.append(data)
        mesh_material.append(m.material_id)
        voffset += nv

    if textures:
        # Pad all textures to a common H, W so they stack into one atlas.
        th = max(t.shape[0] for t in textures)
        tw = max(t.shape[1] for t in textures)
        tex = np.zeros((len(textures), th, tw, 3), np.float32)
        for i, t in enumerate(textures):
            t = np.asarray(t, np.float32)
            tex[i, : t.shape[0], : t.shape[1]] = t[..., :3]
    else:
        tex = np.zeros((1, 1, 1, 3), np.float32)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return SceneData(
        positions=dev(np.concatenate(pos_list)),
        faces=dev(np.concatenate(face_list)),
        attrs={s: dev(np.concatenate(lst)) for s, lst in attr_lists.items()},
        mesh_material=dev(np.array(mesh_material, np.int64)),
        albedo=dev(np.array([m.albedo for m in materials], np.float32)),
        texture_id=dev(np.array([m.texture_id for m in materials], np.int32)),
        textures=dev(tex),
        reflectivity=dev(np.array([m.reflectivity for m in materials],
                                  np.float32)),
    )


class Scene:
    """Host-side scene: mesh list + lazily (re)built structure, with the
    ``IScene`` API (`add_mesh`, `remove_mesh`, `update_gpu_scene`) and
    ``march``."""

    def __init__(self, config: RenderConfig = DEFAULT_CONFIG,
                 device: torch.device | str | None = None):
        self.config = config
        self.device = resolve_device(device)
        self._meshes: list[Mesh] = []
        self.materials: list[Material] = [Material()]
        self.textures: list[np.ndarray] = []
        self._dirty = True
        self._data: Optional[SceneData] = None
        self._accel = None

    @staticmethod
    def create(config: RenderConfig = DEFAULT_CONFIG,
               device: torch.device | str | None = None) -> "Scene":
        """``IScene::create``: the structure is chosen by ``config.accel``;
        tensors on ``device``, the card when None."""
        return Scene(config, device)

    def add_mesh(self, mesh: Mesh) -> None:
        self._meshes.append(mesh)
        self._dirty = True

    def remove_mesh(self, mesh: Mesh) -> None:
        """Drop ``mesh`` (the object itself, not an equal one)."""
        self._meshes = [m for m in self._meshes if m is not mesh]
        self._dirty = True

    @property
    def meshes(self) -> list[Mesh]:
        return list(self._meshes)

    def data(self) -> SceneData:
        """Flattened tensors, rebuilt lazily after a mesh change."""
        if self._dirty or self._data is None:
            self._data = flatten_meshes(self._meshes, self.materials,
                                        self.textures, self.device)
            self._accel = None
            self._dirty = False
        return self._data

    def update_gpu_scene(self):
        """Rebuild the structure over the flattened scene: the LBVH (BVH
        and WAVEFRONT), the cluster set, the hash grid, or None for
        BRUTE."""
        data = self.data()
        if self.config.accel in (AccelKind.BVH, AccelKind.WAVEFRONT):
            from ..accel.bvh import build_bvh

            self._accel = build_bvh(data.positions, data.faces,
                                    self.config.bvh)
        elif self.config.accel is AccelKind.CLUSTER:
            from ..accel.clusters import build_clusters

            self._accel = build_clusters(data.positions, data.faces,
                                         self.config.cluster)
        elif self.config.accel is AccelKind.GRID:
            from ..accel.grid import build_grid

            self._accel = build_grid(data.positions, data.faces,
                                     self.config.grid)
        return self._accel

    @property
    def accel(self):
        if self._accel is None and self.config.accel is not AccelKind.BRUTE:
            self.update_gpu_scene()
        return self._accel

    def march(self, eye, orient, camera, render_target) -> int:
        """Trace the scene into ``render_target``'s buffer: error 8 without
        a target, 5 when its size is not the camera's (`Scene.cpp:81-97`),
        else 0."""
        if render_target is None:
            return ERROR_NO_RENDER_TARGET
        if (render_target.width != camera.width
                or render_target.height != camera.height):
            return ERROR_RT_CAM_MISMATCH
        from ..trace.pipeline import trace_to_buffer

        dev = self.device
        render_target.buffer = trace_to_buffer(
            self.data(), self.accel, camera.initial_rays.to(dev),
            torch.as_tensor(eye, dtype=torch.float32, device=dev),
            torch.as_tensor(orient, dtype=torch.float32, device=dev),
            self.config, frame_hw=(camera.height, camera.width))
        return ERROR_ALL_FINE
