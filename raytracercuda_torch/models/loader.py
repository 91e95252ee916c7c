"""OBJ/MTL model loading into the port's meshes (counterpart of
`raytracercuda_tpu/models/loader.py`).

The analog of the reference's Assimp-based model loader
(`TestProgram/Model.cpp:26-126`): triangulated import, per-material
sub-meshes, unified vertex indices, position/normal/uv/tangent/bitangent
slots filled, face/vertex stats reported.  Textures come from MTL
``map_Kd`` entries through the BMP decoder.

The port's native C++ tokenizer (`native/native_loader.py`, built from
`csrc/obj_loader.cpp`) parses when it builds; otherwise the Python parser
below does.  ``parse_routes`` counts which one ran.  Everything here is
host-side numpy: the scene's tensors are made by `Scene.data()` on the
scene's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..errors import ERROR_ALL_FINE, ERROR_INVALID_PARAMETER, ERROR_NO_VERTICES
from ..native import native_loader
from ..utils.bmp import read_bmp
from .mesh import (
    Mesh,
    VERTEX_DATA_BITANGENT,
    VERTEX_DATA_NORMAL,
    VERTEX_DATA_POSITION,
    VERTEX_DATA_TANGENT,
    VERTEX_DATA_UV1,
)
from .scene import Material, Scene

#: OBJ parses by route: the native tokenizer or the Python parser.
parse_routes = {"native": 0, "python": 0}


@dataclass
class ObjData:
    """Raw parse result: one group of triangles per material."""

    positions: np.ndarray  # [N,3] float32 unified vertices
    normals: np.ndarray | None  # [N,3] or None
    uvs: np.ndarray | None  # [N,2] or None
    groups: list[tuple[str, np.ndarray]] = field(default_factory=list)
    # groups: (material_name, [F,3] int32 indices into unified vertices)
    materials: dict[str, dict] = field(default_factory=dict)
    mtl_files: list[str] = field(default_factory=list)


def _parse_mtl(path: str) -> dict[str, dict]:
    mats: dict[str, dict] = {}
    cur: dict | None = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = {"name": parts[1], "Kd": (1.0, 1.0, 1.0), "map_Kd": None}
                mats[parts[1]] = cur
            elif cur is not None and key == "Kd" and len(parts) >= 4:
                cur["Kd"] = tuple(float(x) for x in parts[1:4])
            elif cur is not None and key == "map_Kd" and len(parts) >= 2:
                cur["map_Kd"] = parts[-1]
    return mats


def parse_obj(path: str) -> ObjData:
    """OBJ parser: v/vn/vt/f (+usemtl/mtllib), fan triangulation, negative
    indices, unified (v,vt,vn) vertices.  The native tokenizer when it
    builds, else the Python parser."""
    parsed = native_loader.parse_obj(path)
    if parsed is not None:
        parse_routes["native"] += 1
        return _finalize_parse(path, *parsed)
    parse_routes["python"] += 1
    positions: list[tuple] = []
    normals: list[tuple] = []
    uvs: list[tuple] = []
    corners: list[tuple[int, int, int]] = []  # (v, vt, vn), -1 when absent
    group_mat: list[str] = []
    cur_mat = ""
    mtl_files: list[str] = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            key = parts[0]
            if key == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vt":
                uvs.append((float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0))
            elif key == "f":
                refs = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = int(comps[0])
                    ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                    # 1-based; negatives are relative to current count.
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = ti - 1 if ti > 0 else (len(uvs) + ti if ti else -1)
                    ni = ni - 1 if ni > 0 else (len(normals) + ni if ni else -1)
                    refs.append((vi, ti, ni))
                for k in range(1, len(refs) - 1):  # fan triangulation
                    corners.extend((refs[0], refs[k], refs[k + 1]))
                    group_mat.append(cur_mat)
            elif key == "usemtl":
                cur_mat = parts[1] if len(parts) > 1 else ""
            elif key == "mtllib" and len(parts) > 1:
                mtl_files.append(parts[1])

    return _finalize_parse(
        path,
        np.array(positions, np.float32).reshape(-1, 3),
        np.array(normals, np.float32).reshape(-1, 3),
        np.array(uvs, np.float32).reshape(-1, 2),
        np.array(corners, np.int64).reshape(-1, 3, 3),
        group_mat,
        mtl_files,
    )


def _finalize_parse(path, v, vn, vt, corners, face_mats, mtl_files) -> ObjData:
    """Unify (v,vt,vn) corner triples into shared vertices (the
    join-identical-vertices step Assimp performs, `Model.cpp:34`) and split
    faces into per-material groups (per-aiMesh analog)."""
    flat = corners.reshape(-1, 3)  # [3F, (vi,ti,ni)]
    uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
    positions = v[uniq[:, 0]]
    out_uv = None
    if len(vt) and (uniq[:, 1] >= 0).any():
        out_uv = np.where((uniq[:, 1] >= 0)[:, None], vt[np.maximum(uniq[:, 1], 0)], 0.0)
    out_n = None
    if len(vn) and (uniq[:, 2] >= 0).any():
        out_n = np.where((uniq[:, 2] >= 0)[:, None], vn[np.maximum(uniq[:, 2], 0)], 0.0)
    tri_idx = inverse.reshape(-1, 3).astype(np.int32)

    groups: list[tuple[str, np.ndarray]] = []
    face_mats = np.array(face_mats if len(face_mats) else [""] * len(tri_idx))
    for mat in dict.fromkeys(face_mats.tolist()):  # preserve order
        groups.append((mat, tri_idx[face_mats == mat]))

    materials: dict[str, dict] = {}
    base = os.path.dirname(os.path.abspath(path))
    for mtl in mtl_files:
        materials.update(_parse_mtl(os.path.join(base, mtl)))
    return ObjData(
        positions=positions,
        normals=out_n,
        uvs=out_uv,
        groups=groups,
        materials=materials,
        mtl_files=mtl_files,
    )


def compute_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals for meshes without ``vn``."""
    n = np.zeros_like(positions)
    tri = indices.reshape(-1, 3)
    e1 = positions[tri[:, 1]] - positions[tri[:, 0]]
    e2 = positions[tri[:, 2]] - positions[tri[:, 0]]
    fn = np.cross(e1, e2)
    for c in range(3):
        np.add.at(n, tri[:, c], fn)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(lens, 1e-20)).astype(np.float32)


def compute_tangents(positions, normals, uvs, indices):
    """Per-vertex tangent/bitangent from UV gradients — the
    aiProcess_CalcTangentSpace analog (`Model.cpp:36`)."""
    tan = np.zeros_like(positions)
    bit = np.zeros_like(positions)
    tri = indices.reshape(-1, 3)
    e1 = positions[tri[:, 1]] - positions[tri[:, 0]]
    e2 = positions[tri[:, 2]] - positions[tri[:, 0]]
    du1 = uvs[tri[:, 1]] - uvs[tri[:, 0]]
    du2 = uvs[tri[:, 2]] - uvs[tri[:, 0]]
    det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)[:, None]
    t = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) * r
    b = (e2 * du1[:, 0:1] - e1 * du2[:, 0:1]) * r
    for c in range(3):
        np.add.at(tan, tri[:, c], t)
        np.add.at(bit, tri[:, c], b)
    tn = tan / np.maximum(np.linalg.norm(tan, axis=1, keepdims=True), 1e-20)
    bn = bit / np.maximum(np.linalg.norm(bit, axis=1, keepdims=True), 1e-20)
    return tn.astype(np.float32), bn.astype(np.float32)


def load_model(path: str, scene: Scene, scale: float = 1.0) -> bool:
    """``Model::load`` analog (`Model.cpp:26-126`).  Convenience boolean
    wrapper over `load_model_err` — True iff ERROR_ALL_FINE."""
    return load_model_err(path, scene, scale) == ERROR_ALL_FINE


def load_model_err(path: str, scene: Scene, scale: float = 1.0) -> int:
    """``Model::load`` analog (`Model.cpp:26-126`): parse, build one Mesh
    per material group, fill vertex slots, register materials (deduplicated
    by name, after the scene's default material 0) and textures on the
    scene, report stats.

    Returns an ERROR_* status code (`Beam.h:8-16` parity): ERROR_ALL_FINE
    on success, ERROR_INVALID_PARAMETER for a missing file,
    ERROR_NO_VERTICES for an OBJ without faces; a mesh slot-fill failure
    returns its own code."""
    if not os.path.exists(path):
        return ERROR_INVALID_PARAMETER
    data = parse_obj(path)
    if data.positions.shape[0] == 0:
        return ERROR_NO_VERTICES

    base = os.path.dirname(os.path.abspath(path))
    mat_index: dict[str, int] = {}

    total_faces = total_verts = 0
    for mat_name, tri_idx in data.groups:
        if tri_idx.shape[0] == 0:
            continue
        # Compact to the vertices this group actually uses.
        used, local = np.unique(tri_idx.reshape(-1), return_inverse=True)
        local = local.reshape(-1, 3).astype(np.uint32)
        pos = data.positions[used] * scale
        nv = pos.shape[0]

        mesh = Mesh.create()
        if (err := mesh.set_indices(local.reshape(-1), local.size)) != 0:
            return err
        if (err := mesh.set_vertex_data(pos, nv, 3, VERTEX_DATA_POSITION)) != 0:
            return err
        normals = (
            data.normals[used]
            if data.normals is not None
            else compute_normals(pos, local)
        )
        if (err := mesh.set_vertex_data(normals, nv, 3, VERTEX_DATA_NORMAL)) != 0:
            return err
        if data.uvs is not None:
            uv = data.uvs[used]
            if (err := mesh.set_vertex_data(uv, nv, 2, VERTEX_DATA_UV1)) != 0:
                return err
            tan, bitan = compute_tangents(pos, normals, uv, local)
            if (err := mesh.set_vertex_data(tan, nv, 3, VERTEX_DATA_TANGENT)) != 0:
                return err
            if (err := mesh.set_vertex_data(bitan, nv, 3,
                                            VERTEX_DATA_BITANGENT)) != 0:
                return err

        # Material registration (dedup by name).
        if mat_name not in mat_index:
            info = data.materials.get(mat_name, {})
            tex_id = -1
            map_kd = info.get("map_Kd")
            if map_kd:
                tex_path = os.path.join(base, map_kd)
                if os.path.exists(tex_path):
                    scene.textures.append(read_bmp(tex_path))
                    tex_id = len(scene.textures) - 1
            scene.materials.append(Material(info.get("Kd", (1, 1, 1)), tex_id))
            mat_index[mat_name] = len(scene.materials) - 1
        mesh.material_id = mat_index[mat_name]

        scene.add_mesh(mesh)
        total_faces += local.shape[0]
        total_verts += nv

    # Stats report (`Model.cpp:115-123` prints totals and scene AABB).
    print(
        f"Loaded {path}: {len(data.groups)} group(s), "
        f"{total_verts} vertices, {total_faces} faces"
    )
    return ERROR_ALL_FINE
