"""The plain reference against the program's CPU path at a small size, and
the frozen copies against what they were copied from."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import CPU, small_cell
from portbench import checks, scenes, traffic
from portbench.reference import meshes, render, train


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in Path(render.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        assert not [n for n in names if n.split(".")[0] in
                    ("raytracercuda_torch", "raytracercuda_tpu", "jax")], path


@pytest.mark.parametrize("faces,seed", [(2000, 0), (4056, 7), (12345, 2)])
def test_frozen_mesh_equals_the_programs(faces, seed):
    from raytracercuda_torch.models.mesh import (VERTEX_DATA_NORMAL,
                                                 VERTEX_DATA_POSITION,
                                                 VERTEX_DATA_UV1)
    from raytracercuda_torch.models.procedural import bumpy_sphere_mesh

    mine = meshes.bumpy_sphere(faces, 1.5, (1.0, -2.0, 5.0), 0.3, seed)
    theirs = bumpy_sphere_mesh(faces, 1.5, (1.0, -2.0, 5.0), 0.3, seed)
    assert np.array_equal(mine["faces"], theirs.indices.reshape(-1, 3))
    for key, slot in (("positions", VERTEX_DATA_POSITION),
                      ("normals", VERTEX_DATA_NORMAL), ("uvs", VERTEX_DATA_UV1)):
        assert np.array_equal(mine[key], theirs.vertex_data(slot)), key


def _scene(name: str, seed: int = 3):
    cell = small_cell(name)
    inputs = scenes.make_inputs(cell.config, seed)
    rcfg, scene = scenes.port_scene(inputs, cell.config, CPU)
    return cell, inputs, rcfg, scene


@pytest.mark.parametrize("pose", [0, 1, 3])
def test_frames_equal_the_programs(pose):
    from raytracercuda_torch.trace.frame import FrameRenderer

    cell, inputs, rcfg, scene = _scene("bunny69k.c512.near")
    cfg = cell.config
    w, h = cfg["width"], cfg["height"]
    data = scene.data()
    pos = np.concatenate([m["positions"] for m in inputs.meshes])
    eyes, orients = traffic.orbit(cell.traffic, (pos.min(0) + pos.max(0)) / 2,
                                  1.0, float((pos.max(0) - pos.min(0)).max()))
    eye, orient = torch.tensor(eyes[pose]), torch.tensor(orients[pose])
    rays = render.camera_rays(w, h)
    frame = FrameRenderer(data, scene.accel, rcfg, h, w,
                          light_dir=cfg["light_dir"]).render(eye, orient, rays)
    want = render.render_frame(scenes.ref_scene(inputs, CPU), eye, orient,
                               rays, w, h, scenes.shading(cfg))
    assert int((want != int(render.pack(torch.tensor([[0.0, 1.0, 0.0]]))[0]))
               .sum()) > 0
    assert checks.frame_px_off(frame, want) == 0.0


def test_differentiable_image_and_adam_steps_equal_the_programs():
    from raytracercuda_torch.accel.clusters import build_clusters
    from raytracercuda_torch.diff.render_grad import l2_image_loss, render_rgb

    cell, inputs, rcfg, scene = _scene("armadillo346k-f16.c1024.adam")
    cfg = cell.config
    w, h = cfg["width"], cfg["height"]
    data = scene.data()
    eye, orient = (torch.tensor(x) for x in traffic.view(cfg))
    rays = render.camera_rays(w, h)
    ref = scenes.ref_scene(inputs, CPU)
    sh = scenes.shading(cfg)
    got = render_rgb(data, scene.accel, rays, eye, orient, rcfg,
                     with_shadows=True, frame_hw=(h, w))
    want = render.render_rgb(ref, eye, orient, rays, w, h, sh)
    assert float((got - want).abs().max()) < 1e-5

    target = torch.tensor(traffic.target(w, h, 3, 3))
    leaves = [data.positions.clone().requires_grad_(),
              data.textures.clone().requires_grad_()]
    opt = torch.optim.Adam(leaves, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for step in range(3):
        accel = build_clusters(leaves[0].detach(), data.faces, rcfg.cluster)
        loss = l2_image_loss(data._replace(positions=leaves[0],
                                           textures=leaves[1]),
                             accel, rays, eye, orient, target, rcfg,
                             frame_hw=(h, w), with_shadows=True)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if step == 0:
            grads = [float((opt.state[x]["exp_avg"] / 0.1).norm())
                     for x in leaves]
    change = [float((x.detach() - s).norm())
              for x, s in zip(leaves, (data.positions, data.textures))]
    steps = train.adam_steps(ref, eye, orient, rays, w, h, target, sh,
                             train.AdamSettings(1e-2, 0.9, 0.999, 1e-8), 3)
    gaps = checks.train_gaps(losses, grads, change, steps)
    assert all(v < 1e-5 for v in gaps.values()), gaps


def test_halton_matches_the_programs():
    from raytracercuda_torch.trace.progressive import halton

    for k in range(1, 70):
        for base in (2, 3):
            assert abs(render.halton(k, base) - float(halton(k, base))) \
                <= 1e-7
