"""Triangle mesh with the reference's 10-slot vertex-attribute model.

TPU-native analog of ``IMesh``/``Mesh`` (`Raytracer/Beam.h:47-54`,
`Raytracer/Mesh.{h,cpp}`): up to 10 named vertex-data slots of 1-4 float
components (position forced to 3), an index buffer, and the same parameter
validation / error codes (`Mesh.cpp:30-54`).  Data lives as numpy/JAX arrays
instead of per-slot ``DeviceBuffer`` allocations — device placement is XLA's
job, not the mesh's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..errors import (
    ERROR_ALL_FINE,
    ERROR_INVALID_PARAMETER,
)

# Vertex-data slot ids (`Raytracer/Beam.h:19-29`).
VERTEX_DATA_POSITION = 0
VERTEX_DATA_NORMAL = 1
VERTEX_DATA_UV1 = 2
VERTEX_DATA_UV2 = 3
VERTEX_DATA_TANGENT = 4
VERTEX_DATA_BITANGENT = 5
VERTEX_DATA_EXTRA1 = 6
VERTEX_DATA_EXTRA2 = 7
VERTEX_DATA_EXTRA3 = 8
VERTEX_DATA_EXTRA4 = 9
VERTEX_DATA_COUNT = 10


class Mesh:
    """A triangle mesh: index buffer + up to 10 vertex-attribute slots."""

    def __init__(self) -> None:
        self._vertex_data: list[Optional[np.ndarray]] = [None] * VERTEX_DATA_COUNT
        self._vertex_data_sizes: list[int] = [0] * VERTEX_DATA_COUNT
        self._indices: Optional[np.ndarray] = None
        self._num_vertices = 0
        self.material_id: int = 0

    # -- IMesh API (`Beam.h:47-54`) --------------------------------------

    @staticmethod
    def create() -> "Mesh":
        """Factory analog of ``IMesh::create`` (`Mesh.cpp:12-15`)."""
        return Mesh()

    def set_vertex_data(
        self, vertex_data, num_vertices: int, num_components: int, slot_id: int
    ) -> int:
        """Validation identical to `Mesh.cpp:30-44`: slot in range, 1-4
        components, vertex count consistent across slots, position forced
        to 3 components."""
        if (
            vertex_data is None
            or num_vertices == 0
            or slot_id >= VERTEX_DATA_COUNT
            or slot_id < 0
            or num_components > 4
            or num_components < 1
            or (self._num_vertices != 0 and self._num_vertices != num_vertices)
            or (slot_id == VERTEX_DATA_POSITION and num_components != 3)
        ):
            return ERROR_INVALID_PARAMETER
        arr = np.asarray(vertex_data, dtype=np.float32).reshape(
            num_vertices, num_components
        )
        self._vertex_data[slot_id] = arr
        self._vertex_data_sizes[slot_id] = num_components
        self._num_vertices = num_vertices
        return ERROR_ALL_FINE

    def set_indices(self, indices, num_indices: int) -> int:
        """Validation identical to `Mesh.cpp:46-54` (count divisible by 3)."""
        if indices is None or num_indices % 3 != 0:
            return ERROR_INVALID_PARAMETER
        self._indices = np.asarray(indices, dtype=np.uint32).reshape(-1)[:num_indices]
        return ERROR_ALL_FINE

    # -- introspection (Mesh.h accessors) ---------------------------------

    def vertex_data(self, slot_id: int) -> Optional[np.ndarray]:
        return self._vertex_data[slot_id]

    def vertex_data_size(self, slot_id: int) -> int:
        return self._vertex_data_sizes[slot_id]

    @property
    def indices(self) -> Optional[np.ndarray]:
        return self._indices

    @property
    def num_vertices(self) -> int:
        return self._num_vertices

    @property
    def num_indices(self) -> int:
        return 0 if self._indices is None else int(self._indices.shape[0])

    @property
    def num_faces(self) -> int:
        return self.num_indices // 3

    @property
    def positions(self) -> np.ndarray:
        p = self._vertex_data[VERTEX_DATA_POSITION]
        assert p is not None, "mesh has no position data"
        return p

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        """Mesh bounds (the reference computes these at model load,
        `TestProgram/Model.cpp:101-113`)."""
        p = self.positions
        return p.min(axis=0), p.max(axis=0)
