"""Kernels A, B, C and H of the port (their plain versions, which the
wrappers run for CPU tensors) against the JAX Pallas kernels in interpret
mode, on the same 64x64 frames and the same cluster set; plus the
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
from raytracercuda_torch.trace import dense as tdense
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
        s["tc"], torch.from_numpy(o3), torch.from_numpy(light),
        torch.from_numpy(hit), trace_cfg=TraceConfig())
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want[~hit].any()


def rows_setup(s):
    """Row-major directions ``[H*W, 3]`` of the frame ``setup`` tiled."""
    d = np.asarray(jdense.untile_pixels(
        jnp.asarray(s["d3"]).transpose(0, 2, 1), SIDE, SIDE, 16))
    return np.array(d), jsweep.segment_blocks(s["jc"]), \
        tsweep.segment_blocks(s["tc"])


# (JAX list width, clip_backward_hits, eye): as PRIMARY_CASES.
DENSE_CASES = {
    "plain": (32, True, (0.0, 0.0, 0.0)),
    "sort_branch": (4, True, (0.0, 0.0, 0.0)),
    "inside_clip": (32, True, (0.0, 0.0, 3.0)),
    "inside_noclip": (32, False, (0.0, 0.0, 3.0)),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_primary_rows_matches_jax(case):
    """Kernel C's route (`trace_dense`) against `trace_dense_pallas`:
    faces and slots exact apart from near-ties, t/u/v within 1e-6
    relative, the port's t/u/v bit-equal to kernel A's on the same
    rays."""
    width, clip, eye = DENSE_CASES[case]
    s = setup("plain", eye=eye)
    d, jblocks, tblocks = rows_setup(s)
    assert tblocks.shape == (s["tc"].num_clusters, 128, tsweep.GEOM_COLS)
    jcfg = JaxTraceConfig(sweep_list_width=width, clip_backward_hits=clip)
    tcfg = TraceConfig(clip_backward_hits=clip)
    want = jsweep.trace_dense_pallas(s["jc"], jblocks, jnp.asarray(s["eye"]),
                                     jnp.asarray(d), SIDE, SIDE,
                                     trace_cfg=jcfg)
    got = tsweep.trace_dense(s["tc"], tblocks, torch.from_numpy(s["eye"]),
                             torch.from_numpy(d), SIDE, SIDE, trace_cfg=tcfg)
    assert got.face.dtype == torch.int32
    wt, gt = np.asarray(want.t), got.t.numpy()
    hit = np.asarray(want.face) >= 0
    np.testing.assert_array_equal(got.face.numpy() >= 0, hit)
    assert 0 < hit.sum() < hit.size
    assert_slots_match(got.face.numpy(), np.asarray(want.face), gt, wt)
    same = hit & (got.face.numpy() == np.asarray(want.face))
    # XLA contracts multiply-adds on the CPU, so against JAX t holds 1e-5
    # relative (measured 2.2e-6 with the eye inside the shell) and u, v
    # (differences of products scaled by 1/det) 5e-5 absolute, as kernel
    # A's tests hold them; bit-equality with kernel A's plain version,
    # itself held bit-exact against numpy float32, follows.
    assert_rel_close(gt, wt, same, rtol=1e-5)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[same],
                                   np.asarray(getattr(want, k))[same],
                                   rtol=0, atol=5e-5)
    assert (gt[~hit] == FLT_MAX).all() and not got.u.numpy()[~hit].any()
    # The same winners and values as kernel A's sweep, untiled.
    a = tsweep.trace_shade_tiles_planar(
        s["tc"], s["tblocks"], False, torch.from_numpy(s["eye"]),
        torch.from_numpy(s["d3"]), trace_cfg=tcfg)
    for k, plane in ((0, gt), (2, got.u.numpy()), (3, got.v.numpy())):
        np.testing.assert_array_equal(
            tdense.untile_pixels(a[k], SIDE, SIDE, 16).numpy(), plane)
    if not clip:
        assert (gt[hit] < 0).any()  # a backward hit won


@pytest.mark.parametrize("list_width,light", [
    (32, (0.3, 0.9, -0.3)), (4, (0.4, 0.8, -0.45))])
def test_occlusion_rows_matches_jax(list_width, light):
    """Kernel H's route (`occlusion_dense`) against
    `occlusion_dense_pallas`: masks exactly equal."""
    s = setup("plain", num_faces=1200, seed=5)
    d, jblocks, tblocks = rows_setup(s)
    hit_t = np.asarray(jsweep.trace_dense_pallas(
        s["jc"], jblocks, jnp.asarray(s["eye"]), jnp.asarray(d), SIDE,
        SIDE).t)
    hit = hit_t < FLT_MAX
    light = np.asarray(light, np.float32)
    light /= np.linalg.norm(light)
    p = s["eye"] + d * np.minimum(hit_t, 1e6)[:, None]
    o = (np.where(hit[:, None], p, s["eye"]) + light * np.float32(1e-3)
         ).astype(np.float32)
    want = np.asarray(jsweep.occlusion_dense_pallas(
        s["jc"], jblocks, jnp.asarray(o), jnp.asarray(light),
        jnp.asarray(hit), SIDE, SIDE,
        trace_cfg=JaxTraceConfig(sweep_list_width=list_width)))
    got = tsweep.occlusion_dense(s["tc"], tblocks, torch.from_numpy(o),
                                 torch.from_numpy(light),
                                 torch.from_numpy(hit), SIDE, SIDE)
    assert got.dtype == torch.bool and got.shape == (SIDE * SIDE,)
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


# Staged terms: the eye rows of A and C, the light rows of B and H.  Each
# case: geometry rows [1, G, 9], the eye [3] and directions [3, R] (eye
# form), the unit light [3] and origins [3, R] (light form).
_T_EPS = np.float32(1e-4)


def _unit_tri_case(a, b, depth):
    """The triangle v0 = 0, e1 = x, e2 = y, hit from z = -depth: from the
    eye (0, 0, -depth) along (a, b, 1), and from (a, b, -depth) along the
    light +z, each at u = a, v = b, t = depth exactly."""
    geom = np.array([[0, 0, 0, 1, 0, 0, 0, 1, 0]], np.float32)
    a, b = np.broadcast_arrays(np.asarray(a, np.float32),
                               np.asarray(b, np.float32))
    ones = np.ones_like(a)
    return dict(geom=geom, eye=np.array([0, 0, -depth], np.float32),
                dirs=np.stack([a, b, ones]),
                light=np.array([0, 0, 1], np.float32),
                origins=np.stack([a, b, -depth * ones]))


def _staged_case(name):
    rng = np.random.default_rng(len(name))
    if name == "random":
        v0 = rng.uniform(-1, 1, (96, 3))
        e1, e2 = rng.normal(0, 0.4, (2, 96, 3))
        eye = rng.uniform(-0.3, 0.3, 3) + [0, 0, -4]
        aim = v0[rng.integers(0, 96, 200)] + 0.25 * rng.normal(size=(200, 3))
        light = rng.normal(size=3)
        light /= np.linalg.norm(light)
        return dict(geom=np.concatenate([v0, e1, e2], 1)[None],
                    eye=eye, dirs=(aim - eye).T, light=light,
                    origins=(aim - light * rng.uniform(0, 2, (200, 1))).T)
    if name == "det_zero_in_plane":
        # Zero-area triangles, and a ray or light in a triangle's plane.
        geom = np.array([[0, 0, 0, 0, 0, 0, 0, 1, 0],     # e1 = 0
                         [0, 0, 0, 1, 1, 0, 2, 2, 0],     # e2 = 2 e1
                         [0, 0, 0, 1, 0, 0, 0, 1, 0],     # the z = 0 plane
                         [0, 0, 0, 1, 0, 0, 0, 0, 1]],    # e2 along +z
                        np.float32)
        eye = np.array([-1, -1, 0], np.float32)  # in the z = 0 plane
        dirs = np.array([[1, 1, 0], [1, 0.5, 0], [0.3, 0.2, 1],
                         [0, 0, 1], [1, 2, 0]], np.float32).T
        light = np.array([0, 0, 1], np.float32)  # along the last e2
        origins = np.array([[0.2, 0.2, -1], [0.1, 0.0, -0.5],
                            [0.5, 0.5, 0], [0, 0.3, 0.2]], np.float32).T
        return dict(geom=geom[None], eye=eye, dirs=dirs, light=light,
                    origins=origins)
    if name == "det_subnormal":
        tiny = np.float32(1e-20)
        geom = np.array([[0, 0, 0, tiny, 0, 0, 0, tiny, 0],
                         [0, 0, 1, 1e-19, 0, 0, 0, 1e-19, 0]], np.float32)
        return dict(geom=geom[None], eye=np.zeros(3, np.float32),
                    dirs=np.array([[0, 0, 1], [1e-20, 0, 1]],
                                  np.float32).T,
                    light=np.array([0, 0, 1], np.float32),
                    origins=np.array([[0, 0, 0], [0, 0, -1],
                                      [1e-20, 1e-20, -1]], np.float32).T)
    if name == "uv_edges":
        # u or v exactly 0 or 1, u + v exactly 1, and just outside.
        a = np.array([0, 1, 0, 0.25, 0.5, 0.75, 1, -0.0, 0.5, 1.0000001,
                      -1e-7, 0.6], np.float32)
        b = np.array([0, 0, 1, 0.75, 0.5, 0.25, 1e-7, 1, -0.0, 0, 0.4,
                      0.4000001], np.float32)
        return _unit_tri_case(a, b, np.float32(2.0))
    if name == "t_at_t_eps":
        return _unit_tri_case(np.array([0.2, 0.3, 0.0], np.float32),
                              np.array([0.2, 0.1, 0.5], np.float32), _T_EPS)
    if name == "nan_inf_vertices":
        inf, nan = np.float32(np.inf), np.float32(np.nan)
        geom = np.array([[nan, 0, 0, 1, 0, 0, 0, 1, 0],
                         [0, 0, 0, inf, 0, 0, 0, 1, 0],
                         [0, 0, 0, 1, 0, 0, 0, -inf, 0],
                         [0, 0, inf, 1, 0, 0, 0, 1, 0],
                         [0, 0, 0, nan, nan, nan, 0, 1, 0],
                         [0, 0, 0, 1, 0, 0, 0, 1, 0]], np.float32)
        case = _unit_tri_case(np.array([0.2, 0, 0.5], np.float32),
                              np.array([0.3, 0, 0.5], np.float32),
                              np.float32(1.0))
        return {**case, "geom": geom}
    raise KeyError(name)


STAGED_CASES = ["random", "det_zero_in_plane", "det_subnormal", "uv_edges",
                "t_at_t_eps", "nan_inf_vertices"]


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("t_eps", [None, _T_EPS], ids=["no_eps", "eps"])
@pytest.mark.parametrize("form", ["eye", "light"])
@pytest.mark.parametrize("case", STAGED_CASES)
def test_staged_rows_test_as_mt_cols(case, form, t_eps):
    """The plain eye-row and light-row builders, then the plain pair tests
    on their rows, give `_mt_cols`' t, u, v and miss mask bit for bit: the
    eye form from the common eye along each ray's direction (A, C), the
    light form from each ray's origin along the light (B, H)."""
    c = {k: torch.from_numpy(np.asarray(v, np.float32))
         for k, v in _staged_case(case).items()}
    geom = c["geom"].reshape(1, -1, 9)
    tri = tuple(geom[:, :, k:k + 1] for k in range(9))
    if form == "eye":
        table = tsweep._eye_rows_plain(c["eye"], geom)
        d = c["dirs"][None, :, None, :]  # [1, 3, 1, R]
        want = tsweep._mt_cols(tri, c["eye"][0], c["eye"][1], c["eye"][2],
                               d[:, 0], d[:, 1], d[:, 2], t_eps)
        got = tsweep._mt_eye_cols(
            tuple(table[:, :, k:k + 1] for k in range(16)), d[:, 0],
            d[:, 1], d[:, 2], t_eps)
    else:
        table = tsweep._light_rows_plain(c["light"], geom)
        o = c["origins"][None, :, None, :]
        lx, ly, lz = c["light"]
        want = tsweep._mt_cols(tri, o[:, 0], o[:, 1], o[:, 2], lx, ly, lz,
                               t_eps)
        got = tsweep._mt_light_cols(
            tuple(table[:, :, k:k + 1] for k in range(16)), o[:, 0],
            o[:, 1], o[:, 2], lx, ly, lz, t_eps)
    assert table.shape == (*geom.shape[:2], tsweep.STAGED_COLS)
    assert table.dtype == torch.float32
    for name, g, w in zip("tuv", got, want):
        assert g.shape == w.shape, name
        assert torch.equal(_bits(g), _bits(w)), name
    assert torch.equal(got[0] == FLT_MAX, want[0] == FLT_MAX)
    hits = int((want[0] < FLT_MAX).sum())
    if case in ("random", "uv_edges", "t_at_t_eps"):
        assert hits > 0
    if case == "det_subnormal":
        assert hits == 0
    if form == "light" and case in ("det_zero_in_plane", "det_subnormal"):
        assert bool((table[..., 13] == 1.0).any())  # a flagged row
    if case == "t_at_t_eps":
        # t == t_eps exactly: a hit, clipped or not.
        assert bool((want[0] == _T_EPS).any())


def test_staged_rows_rounding():
    """Each staged term is the separate float32 operations of `_mt_cols`:
    the eye rows' tq is summed left to right, and a light row's flag and
    reciprocal come from the rounded det."""
    geom = torch.tensor([[[0.1, 0.2, 0.3, 1e8, 1.0, -1e8, 0.5, 0.25, 3.0],
                          [0, 0, 0, 1, 0, 0, 0, 0, 1]]], dtype=torch.float32)
    eye = torch.tensor([0.7, -0.1, 2.0])
    rows = tsweep._eye_rows_plain(eye, geom)
    tv = eye - geom[..., 0:3]
    e1, e2 = geom[..., 3:6], geom[..., 6:9]
    qv = torch.stack([tv[..., 1] * e1[..., 2] - tv[..., 2] * e1[..., 1],
                      tv[..., 2] * e1[..., 0] - tv[..., 0] * e1[..., 2],
                      tv[..., 0] * e1[..., 1] - tv[..., 1] * e1[..., 0]], -1)
    tq = (e2[..., 0] * qv[..., 0] + e2[..., 1] * qv[..., 1]) \
        + e2[..., 2] * qv[..., 2]
    assert torch.equal(_bits(rows[..., 6:9]), _bits(tv))
    assert torch.equal(_bits(rows[..., 9:12]), _bits(qv))
    assert torch.equal(_bits(rows[..., 12]), _bits(tq))
    assert not rows[..., 13:].any()
    light = torch.tensor([0.0, 0.0, 1.0])
    lrows = tsweep._light_rows_plain(light, geom)
    assert torch.equal(lrows[..., :9], geom)
    assert lrows[0, 1, 13] == 1.0 and lrows[0, 0, 13] == 0.0
    assert torch.isinf(lrows[0, 1, 12])  # 1 / 0
    assert not lrows[..., 14:].any()


def test_cuda_wrappers_reject_cpu_tensors():
    s = setup("plain", num_faces=300)
    lists = tsweep._tile_lists(torch.ones((16, s["tc"].num_clusters),
                                          dtype=torch.bool))
    d3 = torch.from_numpy(s["d3"])
    geom = tsweep.segment_blocks(s["tc"])
    with pytest.raises(ValueError, match="CUDA"):
        tsweep._primary_shade_cuda(lists, torch.zeros(3), d3, s["tblocks"],
                                   False, False, None, geom)
    with pytest.raises(ValueError, match="CUDA"):
        tsweep._occlusion_cuda(lists, torch.ones(3), d3, d3[:, 0] > 0, geom,
                               np.float32(1e-4))
    rows = d3.transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        tsweep._primary_cuda(lists, torch.zeros(3), rows, geom, None)
    with pytest.raises(ValueError, match="CUDA"):
        tsweep._occlusion_rows_cuda(lists, torch.ones(3), rows,
                                    rows[..., 0] > 0, geom, np.float32(1e-4))
    with pytest.raises(ValueError, match="CUDA"):
        tsweep._closest_rays_cuda(lists, d3, d3, d3[:, 0] > 0, geom, None)


def test_pick_plain_only_on_cpu():
    def plain():
        pass

    def cuda():
        pass

    assert tsweep._pick(torch.zeros(1), plain, cuda) is plain
    with pytest.raises(ValueError, match="meta"):
        tsweep._pick(torch.zeros(1, device="meta"), plain, cuda)


def _random_lists(counts, num_clusters, seed):
    """CSR lists with the given per-tile counts: ascending distinct ids."""
    rng = np.random.default_rng(seed)
    survive = np.zeros((len(counts), num_clusters), bool)
    for t, c in enumerate(counts):
        survive[t, rng.choice(num_clusters, c, replace=False)] = True
    return tsweep._tile_lists(torch.from_numpy(survive))


# name: per-tile list counts (clusters in the scene: 40).
SPLIT_CASES = {
    "empty_tiles": [0, 7, 0, 0, 13, 1, 0],
    "one_tile_lists_all": [0, 40, 2, 0],
    "ragged": [5, 9, 17, 3, 40, 11, 1, 6],
    "all_empty": [0, 0, 0],
    "one_tile": [40],
}


@pytest.mark.parametrize("k", [1, 3, 4, 16])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_lists_covers_each_list_once(case, k):
    """Kernels C and F's work items: each tile's list is covered exactly
    once, in order, by consecutive items of at most ``k`` clusters; the
    item array is ``T + ceil(N / k)`` long, sized on the host, and the
    items past the real count are empty."""
    counts = SPLIT_CASES[case]
    lists = _random_lists(counts, 40, seed=len(case) + k)
    items = tsweep.split_lists(lists, k)
    n = int(lists.ids.numel())
    assert items.dtype == torch.int32
    assert items.shape == (3, len(counts) + -(-n // k))
    tile, first, end = (x.numpy() for x in items)
    real = end > first
    assert not (end < first).any()
    assert (first[~real] == 0).all() and (end[~real] == 0).all()
    assert (end - first <= k).all()
    want = sum(-(-c // k) for c in counts)
    assert int(real.sum()) == want
    assert real[:want].all()  # the real items come first
    offsets = lists.offsets.numpy()
    for t, c in enumerate(counts):
        mine = np.flatnonzero(real & (tile == t))
        covered = np.concatenate(
            [np.arange(first[i], end[i]) for i in mine] or [np.zeros(0)])
        np.testing.assert_array_equal(
            covered, np.arange(offsets[t], offsets[t] + c))
        assert (np.diff(mine) == 1).all()  # consecutive, in list order


def _occlusion_inputs(s, num_tiles, rays, seed):
    """Row-major origins ``[T, R, 3]`` in the scene's box, a random light,
    and ~60% of the rays active, none in tile 1."""
    rng = np.random.default_rng(seed)
    tris = s["tc"].tris.reshape(-1, 3).numpy()
    lo, hi = tris.min(axis=0), tris.max(axis=0)
    o = (lo + rng.random((num_tiles, rays, 3)) * (hi - lo)).astype(np.float32)
    light = rng.normal(size=3).astype(np.float32)
    light /= np.linalg.norm(light)
    active = rng.random((num_tiles, rays)) < 0.6
    if num_tiles > 1:
        active[1] = False
    return (torch.from_numpy(light), torch.from_numpy(o),
            torch.from_numpy(active))


# (origin layout, rays per tile): H's row-major [T, R, 3] origins and B's
# planar [T, 3, R], at 9x9 tiles (R = 81, not a multiple of 32) and 16x16.
# The row-major 9x9 cases keep their first ids.
OCCLUSION_ITEM_CASES = [
    pytest.param(layout, rays, case,
                 id=case if (layout, rays) == ("rows", 81)
                 else f"{layout}-{rays}-{case}")
    for layout, rays in (("rows", 81), ("planar", 81), ("rows", 256),
                         ("planar", 256))
    for case in sorted(SPLIT_CASES)]


@pytest.mark.parametrize("layout,rays,case", OCCLUSION_ITEM_CASES)
def test_occlusion_items_or_equals_plain(layout, rays, case):
    """Kernels B's and H's decomposition on the CPU: each tile's list cut
    into work items of ``OCCLUSION_CHUNK`` (B) or ``OCCLUSION_ROWS_CHUNK``
    (H) clusters (`split_lists`), each
    item's any-hit over its own clusters for the rays no earlier item
    flagged, OR-ed, is the plain version's mask over whole lists; tiles
    with no active ray stay unflagged.  B's plain version on planar
    origins and H's on row-major ones give the same mask."""
    s = setup("plain", num_faces=5200, seed=3)
    geom = tsweep.segment_blocks(s["tc"])
    assert geom.shape[0] >= 40
    counts = SPLIT_CASES[case]
    lists = _random_lists(counts, 40, seed=len(case))
    light, o, active = _occlusion_inputs(s, len(counts), rays, len(case))
    t_eps = np.float32(1e-4)
    if layout == "rows":
        plain = tsweep._occlusion_rows_plain
        chunk = tsweep.OCCLUSION_ROWS_CHUNK
    else:
        plain = tsweep._occlusion_plain
        chunk = tsweep.OCCLUSION_CHUNK
        want_rows = tsweep._occlusion_rows_plain(lists, light, o, active,
                                                 geom, t_eps)
        o = o.transpose(1, 2).contiguous()  # [T, 3, R]
    want = plain(lists, light, o, active, geom, t_eps)
    if layout == "planar":
        np.testing.assert_array_equal(want.numpy(), want_rows.numpy())
    items = tsweep.split_lists(lists, chunk)
    got = torch.zeros_like(want)
    for tile, first, end in items.T.tolist():
        if first == end:
            continue
        survive = torch.zeros((len(counts), geom.shape[0]), dtype=torch.bool)
        survive[tile, lists.ids[first:end].long()] = True
        got |= plain(tsweep._tile_lists(survive), light, o, active & ~got,
                     geom, t_eps)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not want[~active].any()
    if max(counts) >= 7:
        assert want.any() and not want[active].all()


def _first_hit_ranks(lists, light, o_tiles, active, blocks, t_eps):
    """The list rank of each active ray's first occluding cluster, -1 where
    none (the plain version's tests, rank by rank)."""
    rank = torch.full(active.shape, -1, dtype=torch.long)
    o = o_tiles.transpose(1, 2)[:, :, None, :]
    for r in range(int(lists.counts.max()) if lists.counts.numel() else 0):
        tiles = (lists.counts > r).nonzero()[:, 0]
        blk = blocks[lists.ids[lists.offsets[tiles].long() + r].long()]
        ot = o[tiles]
        t, _, _ = tsweep._mt_cols(tuple(blk[:, :, k:k + 1] for k in range(9)),
                                  ot[:, 0], ot[:, 1], ot[:, 2], light[0],
                                  light[1], light[2], t_eps)
        new = (t < FLT_MAX).any(dim=1) & (rank[tiles] < 0) & active[tiles]
        rank[tiles] = torch.where(new, r, rank[tiles])
    return rank


@pytest.mark.parametrize("list_width", [32, 4])
def test_occlusion_rows_late_hits_match_jax(list_width, monkeypatch):
    """Kernel H's route (`occlusion_dense`) against `occlusion_dense_pallas`
    on the light, of eight diagonals, whose occluded rays find their first
    hit latest in their ascending lists (past the middle on average), where
    a split sweep's later work items decide: masks exactly equal."""
    s = setup("plain", num_faces=1200, seed=5)
    d, jblocks, tblocks = rows_setup(s)
    hit_t = np.asarray(jsweep.trace_dense_pallas(
        s["jc"], jblocks, jnp.asarray(s["eye"]), jnp.asarray(d), SIDE,
        SIDE).t)
    hit = hit_t < FLT_MAX
    calls = []
    real = tsweep._occlusion_rows_plain

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(tsweep, "_occlusion_rows_plain", spy)

    def inputs(light):
        p = s["eye"] + d * np.minimum(hit_t, 1e6)[:, None]
        return (np.where(hit[:, None], p, s["eye"]) + light * np.float32(1e-3)
                ).astype(np.float32)

    best = None
    for signs in np.array(np.meshgrid([-1, 1], [-1, 1], [-1, 1])).T.reshape(
            -1, 3):
        light = (signs / np.sqrt(3.0)).astype(np.float32)
        calls.clear()
        occ = tsweep.occlusion_dense(s["tc"], tblocks,
                                     torch.from_numpy(inputs(light)),
                                     torch.from_numpy(light),
                                     torch.from_numpy(hit), SIDE, SIDE)
        args = calls[-1]
        rank = _first_hit_ranks(*args)
        found = rank >= 0
        if not found.any():
            continue
        # The share of the list swept up to the first hit: 1 is the last.
        late = float(((rank[found] + 1).double()
                      / args[0].counts[:, None].expand_as(rank)[found]).mean())
        if best is None or late > best[0]:
            best = (late, light, occ)
    late, light, got = best
    assert late > 0.5, late
    want = np.asarray(jsweep.occlusion_dense_pallas(
        s["jc"], jblocks, jnp.asarray(inputs(light)), jnp.asarray(light),
        jnp.asarray(hit), SIDE, SIDE,
        trace_cfg=JaxTraceConfig(sweep_list_width=list_width)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


@pytest.mark.parametrize("rays,packs,ok", [
    (81, False, True), (1024, False, True), (81, True, False),
    (256, True, True), (1025, False, False), (0, False, False)])
def test_check_split_rays_per_tile(rays, packs, ok):
    """H takes any count of rays per tile up to 1024 (its block rounds up
    to whole warps); F and the ray bundles, which pack with ballots over
    exactly the tile's rays, take multiples of 32."""
    if ok:
        tsweep._check_split(rays, packs)
    else:
        with pytest.raises(ValueError, match="1 to 1024"):
            tsweep._check_split(rays, packs)
