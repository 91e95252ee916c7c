"""The port's progressive accumulation (`raytracercuda_torch.trace.
progressive`) against the JAX package's on the CPU: Halton values, the
jittered ray grid, two progressive steps through kernels C and H (their
plain versions; JAX in Pallas interpret mode), and gradients through a
step."""

import numpy as np
import pytest
import torch

from torch_parity import (
    jax_config,
    jax_scene,
    numpy_scene,
    torch_clusters,
    torch_config,
    torch_scene,
)

import jax.numpy as jnp

import raytracercuda_tpu.trace.progressive as jprog
from raytracercuda_tpu.accel.clusters import build_clusters as jax_build

import raytracercuda_torch.trace.progressive as tprog
from raytracercuda_torch.trace import sweep as tsweep


@pytest.mark.parametrize("base", [2, 3, 5])
def test_halton_matches_jax(base):
    for i in (0, 1, 2, 3, 4, 7, 12, 100, 1023):
        want = np.float32(jprog.halton(jnp.int32(i), base))
        got = tprog.halton(i, base)
        assert got.dtype == np.float32 and got == want, (i, got, want)


@pytest.mark.parametrize("jitter", [(0.5, 0.5), (0.25, 0.6666667),
                                    (0.875, 0.037037037)])
def test_jittered_ray_grid_matches_jax(jitter):
    jx, jy = (np.float32(j) for j in jitter)
    want = np.asarray(jprog.jittered_ray_grid(48, 32, jx, jy, zoom=1.3))
    got = tprog.jittered_ray_grid(48, 32, jx, jy, zoom=1.3)
    assert got.shape == (48 * 32, 3) and got.dtype == torch.float32
    # One ulp apart in places, as `camera_ray_grid` is: XLA rounds the
    # 1/sqrt otherwise.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.4e-7)


def setup(side=32, seed=19):
    f = numpy_scene(1200, seed=seed, textured=True)
    js, ts = jax_scene(f), torch_scene(f)
    jcfg = jax_config()
    jc = jax_build(js.positions, js.faces, jcfg.cluster)
    return js, ts, jc, torch_clusters(jc), jcfg, torch_config(), side


EYE = np.asarray([0.05, -0.02, 1.0], np.float32)


def test_two_progressive_steps_match_jax():
    js, ts, jc, tc, jcfg, tcfg, side = setup()
    jstate = jprog.init_progressive(side * side)
    tstate = tprog.init_progressive(side * side)
    tsweep.reset_launch_counts()
    for _ in range(2):
        jstate = jprog.progressive_step(jstate, js, jc, jnp.asarray(EYE),
                                        jnp.eye(3), side, side, jcfg,
                                        with_shadows=True)
        tstate = tprog.progressive_step(tstate, ts, tc,
                                        torch.from_numpy(EYE), torch.eye(3),
                                        side, side, tcfg, with_shadows=True)
    assert tstate.count == int(jstate.count) == 2
    assert not any(tsweep.launch_counts.values())  # CPU: plain versions
    want = np.asarray(jstate.image)
    np.testing.assert_allclose(tstate.image.numpy(), want, rtol=0, atol=1e-5)
    # The jitter moved the samples: the two frames differ.
    first = tprog.progressive_step(tprog.init_progressive(side * side), ts,
                                   tc, torch.from_numpy(EYE), torch.eye(3),
                                   side, side, tcfg, with_shadows=True)
    assert (first.image - tstate.image).abs().max() > 1e-2


def test_gradients_flow_through_progressive_step():
    _, ts, _, tc, _, tcfg, side = setup()
    p = ts.positions.clone().requires_grad_()
    tex = ts.textures.clone().requires_grad_()
    eye = torch.from_numpy(EYE).requires_grad_()
    state = tprog.progressive_step(
        tprog.init_progressive(side * side), ts._replace(positions=p,
                                                         textures=tex),
        tc, eye, torch.eye(3), side, side, tcfg, with_shadows=True)
    (state.image ** 2).mean().backward()
    for g in (p.grad, tex.grad, eye.grad):
        assert torch.isfinite(g).all() and (g != 0).any()
