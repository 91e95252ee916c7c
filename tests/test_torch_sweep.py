"""Kernels A and B of the port (their plain versions, which the wrappers
run for CPU tensors) against the JAX Pallas kernels in interpret mode, on
the same 64x64 direction tiles and the same cluster set; plus the
wrappers' device rules."""

import numpy as np
import pytest
import torch

from torch_parity import (
    SIDE,
    assert_rel_close,
    assert_slots_match,
    jax_scene,
    numpy_scene,
    torch_clusters,
    torch_scene,
)

import jax.numpy as jnp

from raytracercuda_tpu.accel.clusters import build_clusters as jax_build
from raytracercuda_tpu.config import ClusterConfig
from raytracercuda_tpu.config import TraceConfig as JaxTraceConfig
from raytracercuda_tpu.models.camera import camera_ray_grid
from raytracercuda_tpu.trace import dense as jdense
from raytracercuda_tpu.trace import pallas_sweep as jsweep
from raytracercuda_tpu.types import FLT_MAX

from raytracercuda_torch.config import TraceConfig
from raytracercuda_torch.trace import sweep as tsweep


def setup(kind="plain", num_faces=2500, seed=9, eye=(0.0, 0.0, 0.0)):
    f = numpy_scene(num_faces, seed=seed, uv=kind == "uv")
    js, ts = jax_scene(f), torch_scene(f)
    jc = jax_build(js.positions, js.faces, ClusterConfig(cluster_size=128))
    tc = torch_clusters(jc)
    jblocks, has_uv = jsweep.shade_segment_blocks(jc, js)
    tblocks, _ = tsweep.shade_segment_blocks(tc, ts)
    d3 = np.asarray(camera_ray_grid(SIDE, SIDE)).T.copy()
    d3_tiles = np.array(jdense.tile_pixels_planar(jnp.asarray(d3), SIDE,
                                                  SIDE, 16))
    return dict(jc=jc, tc=tc, jblocks=jblocks, tblocks=tblocks,
                has_uv=has_uv, d3=d3_tiles, eye=np.asarray(eye, np.float32))


def run_primary(s, list_width=32, clip=True, with_refl=False):
    jcfg = JaxTraceConfig(sweep_list_width=list_width,
                          clip_backward_hits=clip)
    tcfg = TraceConfig(clip_backward_hits=clip)
    want = jsweep.trace_shade_tiles_planar(
        s["jc"], s["jblocks"], s["has_uv"], jnp.asarray(s["eye"]),
        jnp.asarray(s["d3"]), trace_cfg=jcfg, with_refl=with_refl)
    got = tsweep.trace_shade_tiles_planar(
        s["tc"], s["tblocks"], s["has_uv"], torch.from_numpy(s["eye"]),
        torch.from_numpy(s["d3"]), trace_cfg=tcfg, with_refl=with_refl)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def mt_numpy(blocks, slot, eye, d3, n_attrs):
    """t, u, v and the ``n_attrs`` interpolated attributes of each ray
    against the triangle in ``slot``, in numpy float32 with kernel A's
    operation order."""
    row = blocks.reshape(-1, blocks.shape[-1])[slot]  # [T,R,cols]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (row[..., k]
                                                   for k in range(9))
    dx, dy, dz = d3[:, 0], d3[:, 1], d3[:, 2]
    ox, oy, oz = eye
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    inv = np.float32(1.0) / (e1x * pvx + e1y * pvy + e1z * pvz)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    w_ = np.float32(1.0) - u - v
    lerp = [row[..., a] * w_ + row[..., a + 3] * u + row[..., a + 6] * v
            for a in (9, 10, 11)]
    attrs = lerp + [row[..., 18 + k] for k in range(3)]
    if n_attrs >= 9:
        attrs += [row[..., 21],
                  row[..., 22] * w_ + row[..., 24] * u + row[..., 26] * v,
                  row[..., 23] * w_ + row[..., 25] * u + row[..., 27] * v]
    if n_attrs in (7, 10):
        attrs.append(row[..., 28])
    return [t, u, v] + attrs


# (scene kind, JAX list width, clip_backward_hits, with_refl, eye): width 4
# sends JAX down its sort branch; an eye inside the shell sees hits on
# both sides, so clipping decides which side wins.
PRIMARY_CASES = {
    "plain": ("plain", 32, True, False, (0.0, 0.0, 0.0)),
    "uv_refl": ("uv", 32, True, True, (0.0, 0.0, 0.0)),
    "sort_branch": ("plain", 4, True, False, (0.0, 0.0, 0.0)),
    "inside_clip": ("plain", 32, True, False, (0.0, 0.0, 3.0)),
    "inside_noclip": ("uv", 32, False, False, (0.0, 0.0, 3.0)),
}


@pytest.mark.parametrize("case", sorted(PRIMARY_CASES))
def test_primary_shade_matches_jax(case):
    kind, width, clip, refl, eye = PRIMARY_CASES[case]
    s = setup(kind, eye=eye)
    want, got = run_primary(s, width, clip, refl)
    assert len(got) == len(want) == (13 if kind == "uv" else 10) + refl
    assert got[1].dtype == np.int32
    hit = want[0] < FLT_MAX
    np.testing.assert_array_equal(got[0] < FLT_MAX, hit)
    assert 0 < hit.sum() < hit.size
    assert_slots_match(got[1], want[1], got[0], want[0])
    same = hit & (got[1] == want[1])
    # The port rounds each operation of the kernel's formula on its own:
    # bit-equal to numpy float32 on the same winners.
    ref = mt_numpy(np.asarray(s["jblocks"]), got[1], s["eye"], s["d3"],
                   len(got) - 4)
    for k, r in zip([0, 2, 3] + list(range(4, len(got))), ref):
        np.testing.assert_array_equal(got[k][hit], r[hit], err_msg=str(k))
        assert not got[k][~hit].any() or k == 0  # misses: zero attributes
    # XLA on the CPU contracts multiply-adds (a third of a*b + c*d + e*f
    # round otherwise than in numpy), and u, v and t are differences of
    # products scaled by 1/det.  Against JAX, t holds 1e-5 relative; u and
    # v, off by up to 1.6e-5 in these cases, hold 5e-5 absolute; the
    # attributes interpolated with them (O(1) random vertex normals, off
    # by up to 5.6e-5) hold 2e-4 absolute.
    assert_rel_close(got[0], want[0], same, rtol=1e-5)
    for k in range(2, len(want)):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=0,
                                   atol=5e-5 if k < 4 else 2e-4)
    assert (got[1][~hit] == 0).all()
    if not clip:
        assert (got[0][hit] < 0).any()  # a backward hit won


@pytest.mark.parametrize("list_width,light", [
    (32, (0.3, 0.9, -0.3)), (4, (0.4, 0.8, -0.45)), (32, (-0.7, 0.2, 0.6))])
def test_occlusion_matches_jax(list_width, light):
    s = setup("plain", num_faces=1200, seed=5)
    want_a, _ = run_primary(s)
    t = want_a[0]
    hit = t < FLT_MAX
    light = np.asarray(light, np.float32)
    light /= np.linalg.norm(light)
    p = s["eye"][None, :, None] + s["d3"] * np.minimum(t, 1e6)[:, None, :]
    o3 = (np.where(hit[:, None, :], p, s["eye"][None, :, None])
          + light[None, :, None] * np.float32(1e-3)).astype(np.float32)
    jcfg = JaxTraceConfig(sweep_list_width=list_width)
    want = np.asarray(jsweep.occlusion_tiles_planar(
        s["jc"], s["jblocks"], jnp.asarray(o3), jnp.asarray(light),
        jnp.asarray(hit), trace_cfg=jcfg))
    got = tsweep.occlusion_tiles_planar(
        s["tc"], s["tblocks"], torch.from_numpy(o3), torch.from_numpy(light),
        torch.from_numpy(hit), trace_cfg=TraceConfig())
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want[~hit].any()


def test_mt_subnormal_det_is_miss():
    """A subnormal determinant overflows 1/det; with the origin on the
    vertex the zero numerator gives NaN t, which must be a miss."""
    one = torch.ones((1, 1, 1))
    z = torch.zeros((1, 1, 1))
    tri = (z, z, z, one * 1e-20, z, z, z, one * 1e-20, z)
    t, _, _ = tsweep._mt_cols(tri, z, z, z, z, z, one, np.float32(1e-5))
    assert torch.isfinite(t).all() and (t == FLT_MAX).all()


def test_cuda_wrappers_reject_cpu_tensors():
    s = setup("plain", num_faces=300)
    lists = tsweep._tile_lists(torch.ones((16, s["tc"].num_clusters),
                                          dtype=torch.bool))
    d3 = torch.from_numpy(s["d3"])
    with pytest.raises(ValueError, match="CUDA"):
        tsweep._primary_shade_cuda(lists, torch.zeros(3), d3, s["tblocks"],
                                   False, False, None)
    with pytest.raises(ValueError, match="CUDA"):
        tsweep._occlusion_cuda(lists, torch.ones(3), d3, d3[:, 0] > 0,
                               s["tblocks"], np.float32(1e-4))


def test_pick_plain_only_on_cpu():
    def plain():
        pass

    def cuda():
        pass

    assert tsweep._pick(torch.zeros(1), plain, cuda) is plain
    with pytest.raises(ValueError, match="meta"):
        tsweep._pick(torch.zeros(1, device="meta"), plain, cuda)
