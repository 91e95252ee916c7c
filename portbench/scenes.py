"""A configuration's inputs, made from its file and the run's seed, and
handed alike to the program (through its public scene API) and to the
reference.

The meshes are the configuration's: their sizes and their own seeds are
in its file, so every run traces the same geometry.  The run's seed draws
what varies from run to run: the textures here, and in the traffic the
path's start, the checked frames, the target image and the checked
pixels of a sampled frame.  A material's optional ``reflectivity`` (its
mirror share, 0 where the key is absent) goes to the program's
`Material` and to the reference's per-face `RefScene.face_reflectivity`.
A mesh is a bumpy sphere unless its ``shape`` says ``quad``: the
reference's quad in the plane ``z``, with no uvs (zeros on both sides).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .reference.meshes import bumpy_sphere, quad
from .reference.render import RefScene, Shading

#: Stream numbers of `rng`: one per thing the seed draws.
TEXTURES, PATH, CHECKED, TARGET, SAMPLE = range(5)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one ``stream``, independent of the
    others (any whole seed, negative ones too)."""
    return np.random.default_rng([stream, seed % 2 ** 64])


class Inputs(NamedTuple):
    meshes: list  # bumpy_sphere or quad dicts, in the configuration's order
    materials: list  # (albedo, texture id) a material
    mesh_material: list  # material id a mesh
    textures: list  # [h, w, 3] float32 arrays
    reflectivity: list  # mirror share a material


def _mesh(m: dict) -> dict:
    if m.get("shape", "bumpy_sphere") == "quad":
        return quad(m["z"])
    return bumpy_sphere(m["faces"], m["radius"], tuple(m["center"]),
                        m["bump"], m["mesh_seed"])


def make_inputs(config: dict, seed: int) -> Inputs:
    meshes = [_mesh(m) for m in config["meshes"]]
    gen = rng(seed, TEXTURES)
    textures = [gen.random((h, w, 3), dtype=np.float32)
                for h, w in config["textures"]]
    materials = [(tuple(m["albedo"]), m["texture"])
                 for m in config["materials"]]
    return Inputs(meshes, materials, [m["material"] for m in config["meshes"]],
                  textures, [float(m.get("reflectivity", 0.0))
                             for m in config["materials"]])


def shading(config: dict) -> Shading:
    return Shading(tuple(config["light_dir"]), config["ambient"],
                   tuple(config["background"]), config["t_epsilon"])


def ref_scene(inputs: Inputs, device) -> RefScene:
    """The inputs as the reference takes them: one vertex and face table."""
    pos, faces, nrm, uvs, fmat = [], [], [], [], []
    base = 0
    for m, mat in zip(inputs.meshes, inputs.mesh_material):
        pos.append(m["positions"])
        faces.append(m["faces"] + base)
        nrm.append(m["normals"])
        uvs.append(m.get("uvs", np.zeros((len(m["positions"]), 2),
                                         np.float32)))
        fmat.append(np.full(len(m["faces"]), mat, np.int64))
        base += len(m["positions"])
    th = max((t.shape[0] for t in inputs.textures), default=1)
    tw = max((t.shape[1] for t in inputs.textures), default=1)
    tex = np.zeros((max(len(inputs.textures), 1), th, tw, 3), np.float32)
    for i, t in enumerate(inputs.textures):
        tex[i, :t.shape[0], :t.shape[1]] = t

    def dev(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return RefScene(
        positions=dev(np.concatenate(pos)), faces=dev(np.concatenate(faces)),
        normals=dev(np.concatenate(nrm)), uvs=dev(np.concatenate(uvs)),
        face_material=dev(np.concatenate(fmat)),
        albedo=dev(np.array([a for a, _ in inputs.materials], np.float32)),
        texture_id=dev(np.array([t for _, t in inputs.materials], np.int64)),
        textures=dev(tex),
        face_reflectivity=dev(np.array(inputs.reflectivity,
                                       np.float32)[np.concatenate(fmat)]))


def render_config(config: dict):
    """The program's `RenderConfig` for the configuration."""
    from raytracercuda_torch.config import AccelKind, RenderConfig

    base = RenderConfig(accel=AccelKind(config["accel"]))
    return dataclasses.replace(
        base,
        cluster=dataclasses.replace(
            base.cluster,
            cluster_size=config.get("cluster_size",
                                    base.cluster.cluster_size)),
        trace=dataclasses.replace(
            base.trace, t_epsilon=config["t_epsilon"],
            dense_tile_px=config.get("tile_px", base.trace.dense_tile_px)))


def port_scene(inputs: Inputs, config: dict, device):
    """The inputs through the program's public scene API (`Scene.create`,
    `Scene.add_mesh`): ``(render config, scene)``."""
    from raytracercuda_torch.models.mesh import (VERTEX_DATA_NORMAL,
                                                 VERTEX_DATA_POSITION,
                                                 VERTEX_DATA_UV1, Mesh)
    from raytracercuda_torch.models.scene import Material, Scene

    rcfg = render_config(config)
    scene = Scene.create(rcfg, device=device)
    for m, mat in zip(inputs.meshes, inputs.mesh_material):
        mesh = Mesh.create()
        faces = m["faces"].reshape(-1).astype(np.uint32)
        nv = len(m["positions"])
        errs = [mesh.set_indices(faces, faces.size),
                mesh.set_vertex_data(m["positions"], nv, 3,
                                     VERTEX_DATA_POSITION),
                mesh.set_vertex_data(m["normals"], nv, 3, VERTEX_DATA_NORMAL)]
        if "uvs" in m:
            errs.append(mesh.set_vertex_data(m["uvs"], nv, 2,
                                             VERTEX_DATA_UV1))
        for err in errs:
            if err:
                raise RuntimeError(f"the program refused a mesh: error {err}")
        mesh.material_id = mat
        scene.add_mesh(mesh)
    scene.materials = [Material(albedo=a, texture_id=t, reflectivity=r)
                       for (a, t), r in zip(inputs.materials,
                                            inputs.reflectivity)]
    scene.textures = list(inputs.textures)
    return rcfg, scene
