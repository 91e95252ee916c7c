"""Stand-in meshes, made from numbers alone (a frozen copy of
`raytracercuda_torch/models/procedural.py:bumpy_sphere_mesh`, with its
quad loop written as array operations: the same arrays, bit for bit),
and the reference's hand-built quad.

The Content meshes that the configurations name (bunny.obj, the
armadillo, f16.obj) are not in the repository, so a configuration stands
each of them in with a displaced lat-long sphere of the same triangle
count.  The benchmark hands the arrays made here to the program and to
the reference alike.
"""

from __future__ import annotations

import numpy as np


def bumpy_sphere(num_faces: int, radius: float = 1.0, center=(0.0, 0.0, 3.0),
                 bump: float = 0.15, seed: int = 0) -> dict:
    """A displaced lat-long sphere of exactly ``num_faces`` triangles:
    ``positions [V, 3]`` float32, ``faces [F, 3]`` int64, area-weighted
    smooth ``normals [V, 3]`` float32 and spherical ``uvs [V, 2]``
    float32."""
    rows = max(2, int(np.sqrt(num_faces / 4)))
    cols = max(3, -(-num_faces // (2 * rows)))
    rng = np.random.default_rng(seed)
    th = np.linspace(1e-3, np.pi - 1e-3, rows + 1)
    ph = np.linspace(0.0, 2 * np.pi, cols + 1)[:-1]
    tg, pg = np.meshgrid(th, ph, indexing="ij")  # [rows+1, cols]
    r = np.full(tg.shape, radius)
    for _ in range(6):
        a, b = rng.integers(1, 5, 2)
        phase = rng.uniform(0, 2 * np.pi, 2)
        r += (bump * radius / 6 * np.cos(a * tg + phase[0])
              * np.sin(b * pg + phase[1]))
    x = r * np.sin(tg) * np.cos(pg)
    y = r * np.cos(tg)
    z = r * np.sin(tg) * np.sin(pg)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    pos += np.asarray(center, np.float32)

    # Quad (i, j) gives triangles (a, b, c) and (b, d, c), in row order.
    i = np.arange(rows)[:, None]
    j = np.arange(cols)[None, :]
    a = i * cols + j
    b = i * cols + (j + 1) % cols
    c = (i + 1) * cols + j
    d = (i + 1) * cols + (j + 1) % cols
    quads = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], 2)
    faces = quads.reshape(-1, 3).astype(np.int64)[:num_faces]

    fn = np.cross(pos[faces[:, 1]] - pos[faces[:, 0]],
                  pos[faces[:, 2]] - pos[faces[:, 0]])
    normals = np.zeros_like(pos)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    nrm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = (normals / np.maximum(nrm, 1e-20)).astype(np.float32)
    uvs = np.stack([(pg / (2 * np.pi)).reshape(-1),
                    (tg / np.pi).reshape(-1)], axis=1).astype(np.float32)
    return {"positions": pos, "faces": faces, "normals": normals,
            "uvs": uvs}


def quad(z: float) -> dict:
    """The reference's 2-triangle quad in the plane ``z``
    (`Program.cpp:153-185`): four vertices, faces (0, 1, 2) and (1, 2, 3),
    every normal (0, 0, -1) and no uvs (a missing slot reads as zeros)."""
    pos = np.array([[-1.0, -1.0, z], [0.0, 1.0, z], [1.0, -1.0, z],
                    [2.0, 1.0, z]], np.float32)
    return {"positions": pos,
            "faces": np.array([[0, 1, 2], [1, 2, 3]], np.int64),
            "normals": np.tile(np.array([[0.0, 0.0, -1.0]], np.float32),
                               (4, 1))}
