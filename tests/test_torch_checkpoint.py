"""Checkpoint and resume of the port (`raytracercuda_torch.utils.checkpoint`),
the counterparts of `test_checkpoint.py`'s four tests: a resumed
inverse-rendering run (Adam, `parallel/shard.ADAM`) and a resumed
progressive accumulation equal the uninterrupted runs bit for bit."""

import os

import numpy as np
import pytest
import torch

from torch_parity import time_limit

from raytracercuda_torch import interop
from raytracercuda_torch.config import AccelKind, RenderConfig
from raytracercuda_torch.diff.render_grad import render_rgb
from raytracercuda_torch.models.camera import camera_ray_grid
from raytracercuda_torch.parallel.shard import ADAM
from raytracercuda_torch.trace.progressive import (
    ProgressiveState,
    init_progressive,
    progressive_step,
)
from raytracercuda_torch.utils.checkpoint import (
    CheckpointStore,
    restore_train_state,
    save_train_state,
)

BRUTE = RenderConfig(accel=AccelKind.BRUTE)
EYE, ORIENT = torch.zeros(3), torch.eye(3)


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test's own limit: far above its time on one worker (< 3 s)."""
    with time_limit(60):
        yield


def tri_scene(jitter=0.0):
    """`test_checkpoint.tri_scene`."""
    positions = np.array([[-2.0, -2.0, 3.0], [2.0, -2.0, 3.4],
                          [0.0, 2.5, 3.2]], np.float32) + np.float32(jitter)
    normals = np.array([[0.3, 0.1, -0.95], [-0.2, 0.25, -0.94],
                        [0.05, -0.3, -0.95]], np.float32)
    return interop.scene_from_numpy(
        positions=positions, faces=np.array([[0, 1, 2, 0]], np.int32),
        attrs={1: normals}, mesh_material=np.zeros(1, np.int32),
        albedo=np.array([[0.8, 0.6, 0.4]], np.float32),
        texture_id=np.array([-1], np.int32),
        textures=np.zeros((1, 1, 1, 3), np.float32), device="cpu")


def train_setup():
    """Params, Adam's state of no steps, and a functional step: neither
    input is modified."""
    scene = tri_scene()
    rays = camera_ray_grid(16, 16, device="cpu")
    with torch.no_grad():
        target = render_rgb(tri_scene(0.05), None, rays, EYE, ORIENT, BRUTE)
    params = {"positions": scene.positions.clone()}
    opt_state = ADAM.init(params)

    def step(params, opt_state):
        p = params["positions"].detach().clone().requires_grad_()
        opt = ADAM.make([p])
        opt.load_state_dict(opt_state)
        img = render_rgb(scene._replace(positions=p), None, rays, EYE,
                         ORIENT, BRUTE)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        opt.step()
        # A copy, as the optimizer's next step would update its tensors.
        state = {"state": {k: {n: t.clone() for n, t in v.items()}
                           for k, v in opt.state_dict()["state"].items()},
                 "param_groups": opt.state_dict()["param_groups"]}
        return {"positions": p.detach()}, state, loss.detach()

    return params, opt_state, step


def test_train_resume_bit_identical(tmp_path):
    params, opt_state, step = train_setup()
    ckdir = str(tmp_path / "ck")
    p, s = params, opt_state
    for i in range(5):
        p, s, _ = step(p, s)
        if i == 2:
            assert save_train_state(ckdir, i, p, s)
    p_full = p["positions"].clone()

    step_idx, state = restore_train_state(ckdir, params, opt_state)
    assert step_idx == 2
    p, s = state["params"], state["opt_state"]
    assert p["positions"].dtype == torch.float32
    for _ in range(step_idx + 1, 5):
        p, s, _ = step(p, s)
    assert torch.equal(p["positions"], p_full)
    assert not torch.equal(p_full, params["positions"])


def test_restore_empty_dir_returns_none(tmp_path):
    step, state = restore_train_state(str(tmp_path / "none"), {}, ())
    assert step is None and state is None
    with CheckpointStore(str(tmp_path / "none")) as store:
        assert store.latest_step() is None
        assert store.restore({}) is None


def test_store_retention_and_latest(tmp_path):
    with CheckpointStore(str(tmp_path / "r"), max_to_keep=2) as store:
        for i in range(4):
            assert store.save(i, {"x": torch.full((3,), float(i))})
        assert store.latest_step() == 3
        got = store.restore({"x": torch.zeros(3)})
        assert torch.equal(got["x"], torch.full((3,), 3.0))
        # Retention: the oldest steps are gone, the newest two stay.
        assert store.all_steps() == [2, 3]
        assert torch.equal(store.restore({"x": torch.zeros(3)}, step=2)["x"],
                           torch.full((3,), 2.0))
    # Saves are renamed into place: no temporary file is left behind.
    assert sorted(os.listdir(tmp_path / "r")) == ["step_2.pt", "step_3.pt"]


def test_restore_places_like_state_like(tmp_path):
    """Each tensor takes its counterpart's dtype (and device); a tensor
    with no counterpart stays on the CPU as saved; named tuples and
    scalars come back as they were."""
    with CheckpointStore(str(tmp_path / "d")) as store:
        st = ProgressiveState(accum=torch.arange(6.0).reshape(2, 3), count=7)
        store.save(1, {"st": st, "extra": torch.ones(2, dtype=torch.int32)})
        got = store.restore({"st": ProgressiveState(
            accum=torch.zeros((2, 3), dtype=torch.float64), count=0)})
    assert isinstance(got["st"], ProgressiveState) and got["st"].count == 7
    assert got["st"].accum.dtype == torch.float64
    assert torch.equal(got["st"].accum, torch.arange(6.0, dtype=torch.float64)
                       .reshape(2, 3))
    assert got["extra"].dtype == torch.int32 and got["extra"].device.type \
        == "cpu"


def test_progressive_resume_bit_identical(tmp_path):
    scene = tri_scene()
    st = init_progressive(16 * 16, device="cpu")
    for _ in range(4):
        st = progressive_step(st, scene, None, EYE, ORIENT, 16, 16, BRUTE)
    full = st.image.clone()

    st = init_progressive(16 * 16, device="cpu")
    for _ in range(2):
        st = progressive_step(st, scene, None, EYE, ORIENT, 16, 16, BRUTE)
    with CheckpointStore(str(tmp_path / "p")) as store:
        store.save(st.count, st._asdict())
        got = store.restore(init_progressive(16 * 16, device="cpu")._asdict())
    st2 = ProgressiveState(**got)
    assert st2.count == 2
    for _ in range(2):
        st2 = progressive_step(st2, scene, None, EYE, ORIENT, 16, 16, BRUTE)
    assert torch.equal(st2.image, full)
