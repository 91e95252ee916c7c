"""The port's multi-bounce frame (`raytracercuda_torch.trace.bounce`,
`bounce_sweep`; kernels A, B and F by their plain versions on the CPU)
against the JAX package's (`trace/bounce.py`, `trace/pallas_bounce.py` in
Pallas interpret mode), on `tests/test_bounce.py`'s mirror-box scene.

Tolerances, stated per check:

  * `general_tile_cull`: equal survive matrices; an entry may flip only
    where one of its comparisons sits within 1e-6 (relative) of its
    threshold, since the mean direction is a sum over 256 rays that XLA
    and PyTorch order differently.
  * Kernel F's plain version against JAX's kernel: kernel A's bars from
    `test_torch_sweep.py` (slots equal except near-ties; t within 1e-5
    relative, u and v within 5e-5, attributes within 2e-4 absolute: XLA
    on the CPU contracts multiply-adds); inactive rays carry the miss
    defaults exactly.
  * `_coherence_perm`: equal permutations.
  * Frames: at least 99.5% of pixels `isclose(rtol=1e-4, atol=1e-4)` in
    all three channels (`test_bounce.py:78-82`), for the port's cluster
    route against JAX's Pallas route, for the port's brute route against
    JAX's brute route, and for the port's two routes against each other.
"""

import numpy as np
import pytest
import torch

from torch_parity import (
    assert_rel_close,
    assert_slots_match,
    jax_config,
    torch_clusters,
    torch_config,
    torch_scene,
)

import jax.numpy as jnp

from raytracercuda_tpu.accel.clusters import build_clusters as jax_build
from raytracercuda_tpu.config import ClusterConfig
from raytracercuda_tpu.config import TraceConfig as JaxTraceConfig
from raytracercuda_tpu.models.camera import camera_ray_grid as jax_rays
from raytracercuda_tpu.trace import dense as jdense
from raytracercuda_tpu.trace import pallas_bounce as jbounce
from raytracercuda_tpu.trace import pallas_sweep as jsweep
from raytracercuda_tpu.trace.bounce import render_bounces as jax_render
from raytracercuda_tpu.types import FLT_MAX
from test_bounce import mirror_box_scene

from raytracercuda_torch.config import TraceConfig
from raytracercuda_torch.models.camera import camera_ray_grid
from raytracercuda_torch.trace import bounce_sweep as tbounce
from raytracercuda_torch.trace import sweep as tsweep
from raytracercuda_torch.trace.bounce import reflect, render_bounces
from raytracercuda_torch.trace.pipeline import crop_frame, pad_frame

#: The frames' bar (`test_bounce.py:78-82`).
FRAME_SHARE = 0.995


def mirror_box(seed=3, num_faces=60, uv=False):
    """`mirror_box_scene` for both packages; ``uv`` adds seeded vertex
    uvs.  Returns (JAX scene, port scene, numpy fields)."""
    js = mirror_box_scene(seed=seed, num_faces=num_faces)
    fields = {k: ({s: np.array(a) for s, a in v.items()}
                  if isinstance(v, dict) else np.array(v))
              for k, v in js._asdict().items()}
    if uv:
        rng = np.random.default_rng(seed + 100)
        nv = fields["positions"].shape[0]
        fields["attrs"][2] = rng.random((nv, 2)).astype(np.float32)
        js = js._replace(attrs={s: jnp.asarray(a)
                                for s, a in fields["attrs"].items()})
    return js, torch_scene(fields), fields


def share_close(a, b) -> float:
    return float(np.isclose(a, b, rtol=1e-4, atol=1e-4).all(axis=-1).mean())


def assert_frames_close(a, b, what):
    share = share_close(a, b)
    print(f"{what}: {share:.4f} of pixels within 1e-4")
    assert share >= FRAME_SHARE, f"{what}: only {share:.4f} of pixels match"


# ---------------------------------------------------------------------------
# The pieces: the cull, kernel F and the ray re-binning.
# ---------------------------------------------------------------------------


def cull_margins(o3, d3, a, cmin, cmax):
    """Each ``[T, C]`` entry's smallest relative distance to a threshold
    of `general_tile_cull`'s comparisons, in float64 (NaN in tiles with
    no active ray, which cull everything on both sides)."""
    o3, d3 = o3.astype(np.float64), d3.astype(np.float64)
    cmin, cmax = cmin.astype(np.float64), cmax.astype(np.float64)
    act = a[:, None, :]
    omin = np.where(act, o3, np.inf).min(axis=2)
    omax = np.where(act, o3, -np.inf).max(axis=2)
    dmin = np.where(act, d3, np.inf).min(axis=2)
    dmax = np.where(act, d3, -np.inf).max(axis=2)
    dsum = np.where(act, d3, 0.0).sum(axis=2)
    m = dsum / np.maximum(np.linalg.norm(dsum, axis=1, keepdims=True), 1e-15)
    cos_min = np.where(a, (d3 * m[:, :, None]).sum(axis=1), 1.0).min(axis=1)

    def rel(x, y):
        return np.abs(x - y) / np.maximum(1.0, np.maximum(np.abs(x),
                                                          np.abs(y)))

    margins = [np.abs(cos_min)[:, None] + 0.0 * cmin[None, :, 0]]
    sup = gap2 = 0.0
    for i in range(3):
        margins.append(np.where(dmin[:, i:i + 1] >= 0.0,
                                rel(cmax[None, :, i], omin[:, i:i + 1]),
                                np.inf))
        margins.append(np.where(dmax[:, i:i + 1] <= 0.0,
                                rel(cmin[None, :, i], omax[:, i:i + 1]),
                                np.inf))
        wlo = cmin[None, :, i] - omax[:, i:i + 1]
        whi = cmax[None, :, i] - omin[:, i:i + 1]
        sup = sup + np.maximum(m[:, i:i + 1] * wlo, m[:, i:i + 1] * whi)
        gap2 = gap2 + np.maximum(np.maximum(wlo, -whi), 0.0) ** 2
    margins.append(rel(sup, cos_min[:, None] * np.sqrt(gap2)))
    return np.min(margins, axis=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_general_tile_cull_matches_jax(seed):
    rng = np.random.default_rng(seed)
    js, _, _ = mirror_box(seed=seed, num_faces=300)
    jc = jax_build(js.positions, js.faces, ClusterConfig(cluster_size=8))
    cmin, cmax = np.array(jc.cmin), np.array(jc.cmax)
    T, R = 12, 256
    # Tiles of origins in small boxes with directions around a mean: some
    # narrow cones, some wider than a half-space, one tile all inactive.
    centre = rng.uniform(-2.0, 2.0, (T, 3, 1))
    o3 = (centre + rng.normal(scale=0.2, size=(T, 3, R))).astype(np.float32)
    mean = rng.normal(size=(T, 3, 1))
    spread = np.where(np.arange(T) % 3 == 0, 2.0, 0.15)[:, None, None]
    d3 = mean / np.linalg.norm(mean, axis=1, keepdims=True) \
        + spread * rng.normal(size=(T, 3, R))
    d3 = (d3 / np.linalg.norm(d3, axis=1, keepdims=True)).astype(np.float32)
    a = rng.random((T, R)) > 0.3
    a[5] = False
    want = np.asarray(jbounce.general_tile_cull(
        jnp.asarray(o3), jnp.asarray(d3), jnp.asarray(a), jc.cmin, jc.cmax))
    got = tbounce.general_tile_cull(torch.from_numpy(o3),
                                    torch.from_numpy(d3), torch.from_numpy(a),
                                    torch.from_numpy(cmin),
                                    torch.from_numpy(cmax)).numpy()
    assert got.dtype == np.bool_ and got.shape == want.shape
    assert not got[5].any()
    assert 0 < want.sum() < want.size and not want.all(axis=1).all()
    flipped = got != want
    print(f"cull entries flipped: {int(flipped.sum())} of {flipped.size}")
    with np.errstate(invalid="ignore"):
        margin = cull_margins(o3, d3, a, cmin, cmax)
    assert (margin[flipped] <= 1e-6).all()


def first_bounce_inputs(js, jc, side, inactive_share, seed):
    """Planar first-bounce tiles of a ``side``-pixel frame from the origin,
    as `render_bounces_pallas` builds them, from JAX's primary pass (numpy
    float32); ``inactive_share`` of the active rays switched off."""
    jblocks, has_uv = jsweep.shade_segment_blocks(jc, js)
    d3 = np.asarray(jdense.tile_pixels_planar(jax_rays(side, side).T, side,
                                              side, 16))
    outs = [np.asarray(o) for o in jsweep.trace_shade_tiles_planar(
        jc, jblocks, has_uv, jnp.zeros(3), jnp.asarray(d3),
        with_refl=True)]
    t = np.minimum(outs[0], np.float32(3e37))[:, None, :]
    n = np.stack(outs[4:7], axis=1)
    n = n / np.sqrt(np.maximum((n * n).sum(axis=1, keepdims=True), 1e-30))
    n = np.where((n * d3).sum(axis=1, keepdims=True) > 0, -n, n)
    p = d3 * t
    ddn = (d3 * n).sum(axis=1, keepdims=True)
    nd = (d3 - 2.0 * ddn * n).astype(np.float32)
    o = (p + n * np.float32(1e-3)).astype(np.float32)
    rng = np.random.default_rng(seed)
    active = (outs[0] < FLT_MAX) & (outs[-1] > 0.0)
    active &= rng.random(active.shape) >= inactive_share
    return jblocks, has_uv, o, nd, active


@pytest.mark.parametrize("uv", [False, True])
def test_general_shade_matches_jax(uv):
    js, ts, _ = mirror_box(seed=4, num_faces=300, uv=uv)
    jc = jax_build(js.positions, js.faces, ClusterConfig(cluster_size=128))
    tc = torch_clusters(jc)
    jblocks, has_uv, o3, d3, act = first_bounce_inputs(js, jc, 32, 0.2, 5)
    assert has_uv == uv and tc.num_clusters == 3
    tblocks, _ = tsweep.shade_segment_blocks(tc, ts)
    want = [np.asarray(w) for w in jbounce.trace_shade_general_planar(
        jc, jblocks, has_uv, jnp.asarray(o3), jnp.asarray(d3),
        jnp.asarray(act), trace_cfg=JaxTraceConfig(sweep_list_width=2))]
    tsweep.reset_launch_counts()
    got = [g.numpy() for g in tbounce.trace_shade_general_planar(
        tc, tblocks, has_uv, torch.from_numpy(o3), torch.from_numpy(d3),
        torch.from_numpy(act))]
    assert not any(tsweep.launch_counts.values())  # CPU: the plain version
    assert len(got) == len(want) == (14 if uv else 11)
    assert got[1].dtype == np.int32
    hit = want[0] < FLT_MAX
    np.testing.assert_array_equal(got[0] < FLT_MAX, hit)
    assert hit.sum() >= 5 and not hit[~act].any()
    assert_slots_match(got[1], want[1], got[0], want[0])
    same = hit & (got[1] == want[1])
    assert_rel_close(got[0], want[0], same, rtol=1e-5)
    for k in range(2, len(want)):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=0,
                                   atol=5e-5 if k < 4 else 2e-4)
    # Inactive rays and misses: FLT_MAX, slot 0, zero attributes.
    assert (got[0][~hit] == FLT_MAX).all() and not got[1][~hit].any()
    for k in range(2, len(got)):
        assert not got[k][~hit].any()


def test_general_shade_from_eye_equals_primary():
    """Kernel F's plain version from the eye, every ray active, is kernel
    A's with reflectivity, bit for bit (the culls differ, the hits not)."""
    js, ts, _ = mirror_box(seed=4, num_faces=300, uv=True)
    jc = jax_build(js.positions, js.faces, ClusterConfig(cluster_size=128))
    tc = torch_clusters(jc)
    blocks, has_uv = tsweep.shade_segment_blocks(tc, ts)
    d3 = tbounce.tile_pixels_planar(camera_ray_grid(48, 48, device="cpu").T, 48, 48, 16)
    eye = torch.tensor([0.1, -0.2, 0.0])
    primary = tsweep.trace_shade_tiles_planar(tc, blocks, has_uv, eye, d3,
                                              with_refl=True)
    general = tbounce.trace_shade_general_planar(
        tc, blocks, has_uv, eye[None, :, None].expand(d3.shape), d3,
        torch.ones(d3[:, 0].shape, dtype=torch.bool))
    assert (primary[0] < FLT_MAX).any()
    for a, b in zip(primary, general):
        assert torch.equal(a, b)


def test_coherence_perm_matches_jax():
    rng = np.random.default_rng(8)
    n = 2048
    o = rng.uniform(-1.0, 3.0, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    active = rng.random(n) > 0.25
    lo = np.array([-1.0, -1.0, -1.0], np.float32)
    hi = np.array([3.0, 3.0, 3.0], np.float32)
    want = [np.asarray(x) for x in jbounce._coherence_perm(
        *(jnp.asarray(x) for x in (*o, *d, active, lo, hi)))]
    got = [x.numpy() for x in tbounce._coherence_perm(
        *(torch.from_numpy(x) for x in (*o, *d, active, lo, hi)))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert (~active[got[0][-int((~active).sum()):]]).all()  # inactive last


def test_cuda_wrapper_rejects_cpu_tensors():
    lists = tsweep._tile_lists(torch.ones((2, 3), dtype=torch.bool))
    d3 = torch.zeros((2, 3, 256))
    with pytest.raises(ValueError, match="CUDA"):
        tsweep._general_shade_cuda(lists, d3, d3, d3[:, 0] > 0,
                                   torch.zeros((3, 128, 32)), False, None)


# ---------------------------------------------------------------------------
# The frame.
# ---------------------------------------------------------------------------


def port_frame(ts, tc, side_h, side_w, use_brute=False, **kw):
    return render_bounces(tc, ts, torch.zeros(3),
                          camera_ray_grid(side_w, side_h, device="cpu"), side_h, side_w,
                          torch_config(), use_brute=use_brute, **kw).numpy()


def jax_frame(js, jc, side, use_brute=False, **kw):
    return np.asarray(jax_render(jc, js, jnp.zeros(3), jax_rays(side, side),
                                 side, side, jax_config(),
                                 use_brute=use_brute, **kw))


def setup_frame(seed):
    js, ts, _ = mirror_box(seed=seed)
    jc = jax_build(js.positions, js.faces, ClusterConfig(cluster_size=128))
    return js, ts, jc, torch_clusters(jc)


# (bounces, shadows, seed): 0, 1 and 2 bounces, shadows on and off.
FRAME_CASES = {
    "0_bounces_shadows": (0, True, 3),
    "1_bounce": (1, False, 3),
    "2_bounces_shadows": (2, True, 5),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frame_matches_jax(case):
    nb, shadows, seed = FRAME_CASES[case]
    js, ts, jc, tc = setup_frame(seed)
    kw = dict(num_bounces=nb, with_shadows=shadows)
    want = jax_frame(js, jc, 32, **kw)
    got = port_frame(ts, tc, 32, 32, **kw)
    assert got.shape == (32 * 32, 3) and got.dtype == np.float32
    assert_frames_close(got, want, "port cluster route vs JAX Pallas route")
    brute = port_frame(ts, tc, 32, 32, use_brute=True, **kw)
    assert_frames_close(got, brute, "port cluster route vs port brute route")
    if nb:  # the mirror shows in the frame
        flat = port_frame(ts, tc, 32, 32, num_bounces=0,
                          with_shadows=shadows)
        assert not np.allclose(got, flat, atol=1e-6)


def test_sorted_bounces_match_jax():
    """``sort_bounces`` on `render_bounces_tiled` against JAX's
    `render_bounces_pallas`, and against the unsorted port frame."""
    js, ts, jc, tc = setup_frame(3)
    jblocks, has_uv = jsweep.shade_segment_blocks(jc, js)
    tblocks, _ = tsweep.shade_segment_blocks(tc, ts)
    cfg = JaxTraceConfig(use_pallas_sweep=True)
    want = np.asarray(jbounce.render_bounces_pallas(
        jc, jblocks, has_uv, js.textures, jnp.zeros(3), jax_rays(32, 32), 32,
        32, num_bounces=2, trace_cfg=cfg, sort_bounces=True))
    kw = dict(num_bounces=2, trace_cfg=TraceConfig())
    got = tbounce.render_bounces_tiled(
        tc, tblocks, has_uv, ts.textures, torch.zeros(3),
        camera_ray_grid(32, 32, device="cpu"), 32, 32, sort_bounces=True, **kw).numpy()
    assert_frames_close(got, want, "port sorted bounces vs JAX")
    unsorted = tbounce.render_bounces_tiled(
        tc, tblocks, has_uv, ts.textures, torch.zeros(3),
        camera_ray_grid(32, 32, device="cpu"), 32, 32, **kw).numpy()
    np.testing.assert_array_equal(got, unsorted)


@pytest.mark.parametrize("nb,shadows", [(1, True), (2, False)])
def test_brute_route_matches_jax(nb, shadows):
    js, ts, jc, tc = setup_frame(5)
    kw = dict(num_bounces=nb, with_shadows=shadows)
    want = jax_frame(js, jc, 32, use_brute=True, **kw)
    got = port_frame(ts, tc, 32, 32, use_brute=True, **kw)
    assert_frames_close(got, want, "port brute route vs JAX brute route")


def test_frame_the_tile_does_not_divide():
    """40x24 pads to 48x32 with repeated edge rays and crops back: the
    cluster route still matches the brute route, which needs no tiles."""
    _, ts, _, tc = setup_frame(3)
    got = port_frame(ts, tc, 24, 40, num_bounces=2)
    brute = port_frame(ts, tc, 24, 40, use_brute=True, num_bounces=2)
    assert got.shape == (24 * 40, 3)
    assert_frames_close(got, brute, "40x24 cluster route vs brute route")
    x = torch.arange(24 * 40 * 3, dtype=torch.float32).reshape(-1, 3)
    padded, hp, wp = pad_frame(x, 24, 40, 16)
    assert (hp, wp) == (32, 48)
    img = padded.reshape(32, 48, 3)
    assert torch.equal(img[24:], img[23:24].expand(8, 48, 3))
    assert torch.equal(img[:, 40:], img[:, 39:40].expand(32, 8, 3))
    assert torch.equal(crop_frame(padded, 24, 40, hp, wp), x)


def test_zero_reflectivity_stops_bounces():
    _, ts, _, tc = setup_frame(7)
    ts = ts._replace(reflectivity=torch.zeros(2))
    a = port_frame(ts, tc, 16, 16, num_bounces=0, with_shadows=False)
    b = port_frame(ts, tc, 16, 16, num_bounces=3, with_shadows=False)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_energy_conserving():
    """Path weights sum to 1: no channel exceeds the largest of the local
    shades and the background (`test_bounce.py:135-161`)."""
    _, ts, _, tc = setup_frame(3)
    for nb in (1, 2, 3):
        rgb = port_frame(ts, tc, 32, 32, num_bounces=nb, with_shadows=False)
        assert rgb.max() <= 1.0 + 1e-5, f"bounces={nb}: max {rgb.max()}"
    white = ts._replace(albedo=torch.ones((2, 3)),
                        reflectivity=torch.ones(2))
    for brute in (False, True):
        rgb = port_frame(white, tc, 32, 32, use_brute=brute, num_bounces=2,
                         with_shadows=False, background=(1.0, 1.0, 1.0),
                         light_dir=(0.0, 0.0, -1.0))
        assert rgb.max() <= 1.0 + 1e-5


def test_reflect():
    out = reflect(torch.tensor([[0.0, 0.0, 1.0]]),
                  torch.tensor([[0.0, 0.0, -1.0]]))
    assert torch.equal(out, torch.tensor([[0.0, 0.0, -1.0]]))
