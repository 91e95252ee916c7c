"""Host constants that reach the device without a blocking copy: the light
basis's axes (made on the device once per device), the progressive
jitter (Python scalars) and the render's light direction (copied once
per light and device, then reused).  Each is held bit for bit against
the copies it replaced, and the shared tensors are never written."""

from __future__ import annotations

import pytest
import torch

from raytracercuda_torch.diff import render_grad
from raytracercuda_torch.ops.math import cross
from raytracercuda_torch.trace import shadow
from raytracercuda_torch.trace.progressive import halton, jittered_ray_grid
from raytracercuda_torch.utils import profiler
from test_torch_tracing import CONFIG, Small
from torch_parity import time_limit as _time_limit

LIGHTS = [(0.4, 0.8, -0.45), (-0.3, 0.2, -0.9)]


@pytest.fixture(autouse=True)
def time_limit():
    with _time_limit(120.0):
        yield


@pytest.fixture(scope="module")
def small():
    return Small(faces=600, side=32)


def grid_with_tensor_jitter(width, height, jx, jy, left=-1.0, right=1.0,
                            top=1.0, bottom=-1.0, zoom=1.0):
    """`jittered_ray_grid` as it was with the offsets copied to the device
    as float32 tensors."""
    dx = (right - left) / width
    dy = (bottom - top) / height
    jx = torch.tensor(jx, dtype=torch.float32)
    jy = torch.tensor(jy, dtype=torch.float32)
    rx = left + dx * (torch.arange(width, dtype=torch.float32) + jx)
    ry = top + dy * (torch.arange(height, dtype=torch.float32) + jy)
    gx = rx[None, :].expand(height, width)
    gy = ry[:, None].expand(height, width)
    d = 1.0 / torch.sqrt(zoom * zoom + gx * gx + gy * gy)
    gz = torch.full_like(gx, zoom)
    return torch.stack([gx * d, gy * d, gz * d], dim=-1).reshape(
        height * width, 3)


def basis_with_copied_axes(light_dir):
    """`light_basis` as it was with the unit axes copied from the host."""
    l = light_dir / torch.linalg.vector_norm(light_dir)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32)
    u = cross(l, torch.where(l[0].abs() < 0.9, ex, ey))
    u = u / torch.linalg.vector_norm(u)
    return u, cross(l, u), l


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("shape", [(1024, 1), (64, 48), (37, 29)])
def test_jittered_grid_is_bit_equal_for_the_first_halton_pairs(shape):
    width, height = shape
    for i in range(1, 65):
        jx, jy = halton(i, 2), halton(i, 3)
        assert same_bits(jittered_ray_grid(width, height, jx, jy,
                                           device="cpu"),
                         grid_with_tensor_jitter(width, height, jx, jy)), i


@pytest.mark.parametrize("jitter", [0.1, 1.0 / 3.0, 0.7071067811865476])
def test_jittered_grid_rounds_a_double_jitter_as_before(jitter):
    assert same_bits(
        jittered_ray_grid(40, 24, jitter, 1.0 - jitter, zoom=1.3,
                          device="cpu"),
        grid_with_tensor_jitter(40, 24, jitter, 1.0 - jitter, zoom=1.3))


@pytest.mark.parametrize("light", [
    (0.4, 0.8, -0.45), (0.85, 0.5268, 0.0), (-0.89, 0.456, 0.0),
    (0.8999, 0.1, -0.4243), (0.9001, -0.4357, 0.0), (-0.91, 0.0, 0.4146),
    (0.95, -0.2, 0.1), (-1.0, -0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
    (-0.0, 0.0, -1.0), (0.3, -0.0, 0.0)])
def test_light_basis_is_bit_equal_on_both_sides_of_the_switch(light):
    """|l_x| of the unit light below 0.9 takes the x axis, else the y."""
    l = torch.tensor(light, dtype=torch.float32)
    for a, b in zip(shadow.light_basis(l), basis_with_copied_axes(l)):
        assert same_bits(a, b)


def test_light_basis_axes_are_made_once_and_left_unwritten():
    cpu = torch.device("cpu")
    shadow.light_basis(torch.tensor([0.2, -0.5, 0.8]))
    axes = shadow._unit_axes(cpu)
    version = axes._version
    for light in ([0.95, 0.1, 0.0], [0.1, 0.2, 0.3]):
        shadow.light_basis(torch.tensor(light))
    assert shadow._unit_axes(cpu) is axes
    assert axes._version == version
    assert torch.equal(axes, torch.eye(3)[:2])


def _render(small, light, vjp: bool):
    """A shadowed render of ``small`` toward ``light`` and its gradients:
    ``render_rgb`` runs the occlusion's and the shade's light,
    ``render_rgb_vjp`` the recompute's in its backward too."""
    p = small.data.positions.clone().requires_grad_()
    tex = small.data.textures.clone().requires_grad_()
    scene = small.data._replace(positions=p, textures=tex)
    render = render_grad.render_rgb_vjp if vjp else render_grad.render_rgb
    img = render(scene, small.accel, small.rays, small.eye, small.orient,
                 CONFIG, frame_hw=(small.side, small.side),
                 with_shadows=True, light_dir=light)
    torch.mean((img - small.target) ** 2).backward()
    return img.detach(), p.grad, tex.grad


@pytest.mark.parametrize("vjp", [False, True], ids=["render", "vjp"])
def test_alternating_lights_give_the_bits_of_a_fresh_cache(small, vjp,
                                                           monkeypatch):
    fresh = {}
    for light in LIGHTS:
        monkeypatch.setattr(render_grad, "_LIGHTS", {})
        fresh[light] = _render(small, light, vjp)
    monkeypatch.setattr(render_grad, "_LIGHTS", {})
    for light in LIGHTS * 2:
        for a, b in zip(_render(small, light, vjp), fresh[light]):
            assert same_bits(a, b)
    # One tensor a light on this device, holding the light, unwritten.
    assert len(render_grad._LIGHTS) == len(LIGHTS)
    for (bits, device), l in render_grad._LIGHTS.items():
        assert device == torch.device("cpu") and l._version == 0
        assert tuple(l.view(torch.int32).tolist()) == bits
    assert not same_bits(fresh[LIGHTS[0]][0], fresh[LIGHTS[1]][0])


def test_the_light_copy_keeps_signed_zeros_and_counts_once(monkeypatch):
    monkeypatch.setattr(render_grad, "_LIGHTS", {})
    cpu = torch.device("cpu")
    with profiler.tracing():
        a = render_grad._light_on((0.0, 1.0, 0.0), cpu, "sync.a")
        b = render_grad._light_on((-0.0, 1.0, 0.0), cpu, "sync.b")
        again = render_grad._light_on([0.0, 1.0, 0.0], cpu, "sync.c")
    record = profiler.collect()
    assert again is a and b is not a
    assert torch.signbit(b[0]) and not torch.signbit(a[0])
    assert [s.name for s in record.spans] == ["sync.a", "sync.b"]
    assert record.counters == {"host_syncs": 2}
    t = torch.tensor([0.4, 0.8, -0.45], dtype=torch.float64)
    assert same_bits(render_grad._light_on(t, cpu, "sync.d"),
                     t.to(torch.float32))


def test_the_light_cache_keeps_its_newest_entries(monkeypatch):
    monkeypatch.setattr(render_grad, "_LIGHTS", {})
    cpu = torch.device("cpu")
    lights = [(0.1 * k, 1.0, -0.5) for k in range(
        render_grad._LIGHTS_KEPT + 8)]
    for light in lights:
        l = render_grad._light_on(light, cpu, "sync.light")
        assert same_bits(l, torch.tensor(light, dtype=torch.float32))
    assert len(render_grad._LIGHTS) == render_grad._LIGHTS_KEPT
    assert render_grad._light_on(lights[-1], cpu, "sync.light") is l
