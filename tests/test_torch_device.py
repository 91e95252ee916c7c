"""The port's entry points run on the card unless the caller asks for the
CPU: on a torch without CUDA, each call without ``device`` raises
(it never carries on on the CPU), and each call with ``device="cpu"``
works."""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (the import guard)

import raytracercuda_torch as trt
from raytracercuda_torch import interop
from raytracercuda_torch.device import resolve_device
from raytracercuda_torch.models.procedural import quad_mesh
from raytracercuda_torch.ops.blob import blob
from raytracercuda_torch.ops.clear import clear_buffer
from raytracercuda_torch.ops.gradient import color_gradient
from raytracercuda_torch.trace import progressive


def _scene_data(**kw):
    scene = trt.Scene.create(trt.RenderConfig(accel=trt.AccelKind.BRUTE),
                             **kw)
    scene.add_mesh(quad_mesh())
    return scene.data()


def _scene_from_numpy(**kw):
    return interop.scene_from_numpy(
        np.zeros((3, 3), np.float32), np.array([[0, 1, 2, 0]]), {},
        np.zeros(1, np.int64), np.ones((1, 3), np.float32),
        np.full(1, -1, np.int32), np.zeros((1, 1, 1, 3), np.float32), **kw)


ENTRY_POINTS = {
    "render_target": lambda **kw: trt.RenderTarget.create(4, 4, **kw).buffer,
    "scene_data": lambda **kw: _scene_data(**kw).positions,
    "camera_ray_grid": lambda **kw: trt.camera_ray_grid(4, 4, **kw),
    "camera": lambda **kw: trt.Camera.create(**kw).set_initial_rays(4, 4),
    "clear_buffer": lambda **kw: clear_buffer(16, 0, **kw),
    "color_gradient": lambda **kw: color_gradient(4, 4, **kw),
    "blob": lambda **kw: blob(8, 4, 0.5, **kw),
    "jittered_ray_grid": lambda **kw: progressive.jittered_ray_grid(
        4, 4, 0.5, 0.5, **kw),
    "init_progressive": lambda **kw: progressive.init_progressive(16, **kw)
    .accum,
    "scene_from_numpy": lambda **kw: _scene_from_numpy(**kw).positions,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_is_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("this torch has CUDA: the default is a real device here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_on_request(name):
    out = ENTRY_POINTS[name](device="cpu")
    if isinstance(out, torch.Tensor):
        assert out.device.type == "cpu"
    else:
        assert out == trt.ERROR_ALL_FINE


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
