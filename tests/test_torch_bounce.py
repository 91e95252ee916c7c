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

`general_tile_cull` is one launch of `csrc/cull.cu`'s
`general_cull_kernel` on the card and the plain chain
(`_general_cull_plain`) on the CPU.  The tests marked ``card`` need an
NVIDIA GPU and skip without one; the card's machine has no jax, so
there this file imports neither jax nor the JAX package and only those
tests run: ``python -m pytest tests/test_torch_bounce.py -m card -s
--noconftest``.  On the card every mask entry that differs from the
chain's must lie within `chip_smoke.CULL_THRESHOLD_REL` of a threshold
by `cull_margins`, and bounce frames are bit-equal to the chain's.
"""

import importlib.util

import numpy as np
import pytest
import torch

from chip_smoke import CULL_THRESHOLD_REL, general_margin
from raytracercuda_torch.config import TraceConfig
from raytracercuda_torch.models.camera import camera_ray_grid
from raytracercuda_torch.trace import bounce_sweep as tbounce
from raytracercuda_torch.trace import sweep as tsweep
from raytracercuda_torch.trace.bounce import reflect, render_bounces
from raytracercuda_torch.trace.pipeline import (crop_frame, pad_frame,
                                                rotate_rays)
from test_torch_cull import _card, config_scene, orbit
from test_torch_tracing import CONFIG

if importlib.util.find_spec("jax") is not None:
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


def cull_margins(o3, d3, a, cmin, cmax, tiles=None, clusters=None):
    """Each ``[T, C]`` entry's smallest relative distance to a threshold
    of `general_tile_cull`'s comparisons, in float64: `chip_smoke.
    general_margin` on numpy inputs (inf in tiles with no active ray,
    which cull everything on both sides); with ``tiles`` and ``clusters``
    (index arrays of one length), only those pairs'."""
    full = tiles is None
    if full:
        tiles, clusters = (x.reshape(-1) for x in np.meshgrid(
            np.arange(a.shape[0]), np.arange(cmin.shape[0]), indexing="ij"))
    margin = general_margin(*(torch.from_numpy(np.asarray(x)) for x in (
        o3, d3, a, cmin, cmax, tiles, clusters))).numpy()
    return margin.reshape(a.shape[0], cmin.shape[0]) if full else margin


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
    margin = cull_margins(o3, d3, a, cmin, cmax)
    assert (margin[flipped] <= 1e-6).all()


#: bounce2's general culls (multimesh515k.c1080): a 1920x1088 frame's
#: 16-pixel tiles over the configuration's clusters.
BOUNCE2_TILES, BOUNCE2_CLUSTERS = 8160, 4027


def general_case(case: str, seed: int = 11):
    """Numpy float32 inputs of a general cull, ``(o3 [T, 3, R], unit d3
    [T, 3, R], a [T, R] bool, cmin, cmax [C, 3])``: ``"bounce2"`` at
    bounce2's shapes, ``"bundle"`` 2,000 rays in `trace_rays`' groups of
    256 (the last group padded with inactive rays).  Tiles of origins in
    small boxes with directions around a mean, every third cone wider
    than a half-space, tile 5 all inactive; boxes of 0.02-0.3 half-extent
    among the origins."""
    rng = np.random.default_rng(seed)
    if case == "bounce2":
        T, R, C = BOUNCE2_TILES, 256, BOUNCE2_CLUSTERS
    else:
        T, R, C = 8, 256, 600
    centre = rng.uniform(-2.0, 2.0, (T, 3, 1))
    o3 = centre + rng.normal(scale=0.2, size=(T, 3, R))
    mean = rng.normal(size=(T, 3, 1))
    spread = np.where(np.arange(T) % 3 == 0, 2.0, 0.15)[:, None, None]
    d3 = mean / np.linalg.norm(mean, axis=1, keepdims=True) \
        + spread * rng.normal(size=(T, 3, R))
    d3 = d3 / np.linalg.norm(d3, axis=1, keepdims=True)
    a = rng.random((T, R)) > 0.3
    a[5] = False
    if case == "bundle":  # row-major rays through `group_rays`
        n = 2000
        rows = [torch.from_numpy(x.transpose(0, 2, 1).reshape(-1, 3)[:n])
                for x in (o3, d3)]
        o3, d3 = (tbounce.group_rays(x, R).transpose(1, 2).numpy()
                  for x in rows)
        a = tbounce.group_rays(torch.from_numpy(a.reshape(-1)[:n]),
                               R).numpy()
    mid = rng.uniform(-3.0, 3.0, (C, 3))
    half = rng.uniform(0.02, 0.3, (C, 3))
    return (o3.astype(np.float32), d3.astype(np.float32), a,
            (mid - half).astype(np.float32), (mid + half).astype(np.float32))


def cull_gate(got, want, o3, d3, a, cmin, cmax):
    """The card's gate on a kernel's mask ``got`` against the chain's
    ``want`` (bool tensors) on the numpy inputs: ``(entries that differ,
    their largest margin by `cull_margins`)``.  The mask passes when that
    margin is within `CULL_THRESHOLD_REL`."""
    bad = (got != want).nonzero().cpu().numpy()
    if not len(bad):
        return 0, 0.0
    return len(bad), float(cull_margins(o3, d3, a, cmin, cmax, bad[:, 0],
                                        bad[:, 1]).max())


def test_general_tile_cull_runs_the_chain_on_the_cpu(monkeypatch):
    """On CPU tensors `general_tile_cull` is the plain chain, culled
    detached, and launches nothing."""
    o3, d3, a, cmin, cmax = (torch.from_numpy(x)
                             for x in general_case("bundle"))
    calls = []

    def chain(*args):
        calls.append(args)
        return plain(*args)

    plain = tbounce._general_cull_plain
    monkeypatch.setattr(tbounce, "_general_cull_plain", chain)
    tsweep.reset_launch_counts()
    got = tbounce.general_tile_cull(o3.requires_grad_(), d3, a, cmin, cmax)
    assert len(calls) == 1 and not any(x.requires_grad for x in calls[0])
    assert not any(tsweep.launch_counts.values())
    assert torch.equal(got, plain(o3.detach(), d3, a, cmin, cmax))
    assert got.dtype == torch.bool and got.shape == (8, 600)
    assert not got[5].any() and 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("wrong", ["keeps_all", "keeps_none"])
def test_the_card_gate_refuses_a_general_mask_off_its_thresholds(wrong):
    """`cull_gate` refuses a mask that keeps every cluster, or none: it
    differs from the chain at tests far from their thresholds, also in
    the tiles that have active rays."""
    case = general_case("bundle")
    want = tbounce._general_cull_plain(*(torch.from_numpy(x) for x in case))
    got = torch.full_like(want, wrong == "keeps_all")
    got[5] = False  # the tile with no active ray as the chain has it
    differ, worst = cull_gate(got, want, *case)
    assert differ > 0 and worst > CULL_THRESHOLD_REL
    assert cull_gate(want.clone(), want, *case) == (0, 0.0)


def test_general_cull_kernel_rejects_cpu_tensors():
    o3, d3, a, cmin, cmax = (torch.from_numpy(x)
                             for x in general_case("bundle"))
    with pytest.raises(ValueError, match="CUDA"):
        tbounce._general_cull_cuda(o3, d3, a, cmin, cmax)


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


# ---------------------------------------------------------------------------
# The general cull on the card (`csrc/cull.cu`'s general_cull_kernel).
# ---------------------------------------------------------------------------


def cone_cosines(d3, a):
    """Each tile's least cosine of an active ray to the unit mean of its
    active directions, in float64 (1 where the tile has none)."""
    d3 = d3.astype(np.float64)
    dsum = np.where(a[:, None, :], d3, 0.0).sum(axis=2)
    m = dsum / np.maximum(np.linalg.norm(dsum, axis=1, keepdims=True), 1e-15)
    return np.where(a, (d3 * m[:, :, None]).sum(axis=1), 1.0).min(axis=1)


@pytest.mark.card
@pytest.mark.parametrize("case", ["bounce2", "bundle"])
def test_general_cull_kernel_matches_the_chain_on_the_card(case):
    """`general_tile_cull` on the card against `_general_cull_plain` run
    there, at bounce2's shapes and at a `trace_rays` bundle's: one launch,
    the tile with no active ray culled whole, narrow cones and cones wider
    than a half-space, each differing entry within `CULL_THRESHOLD_REL` of
    a threshold."""
    dev = _card()
    case_np = general_case(case)
    o3, d3, a, cmin, cmax = (torch.from_numpy(x).to(dev) for x in case_np)
    cos_min = cone_cosines(case_np[1], case_np[2])[case_np[2].any(axis=1)]
    assert (cos_min <= 0.0).any() and (cos_min > 0.0).any()
    tsweep.reset_launch_counts()
    got = tbounce.general_tile_cull(o3, d3, a, cmin, cmax)
    torch.cuda.synchronize()
    assert tsweep.launch_counts["general_cull"] == 1
    want = tbounce._general_cull_plain(o3, d3, a, cmin, cmax)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert not got[5].any() and 0 < int(got.sum()) < got.numel()
    differ, worst = cull_gate(got, want, *case_np)
    print(f"{case}: {differ} of {got.numel()} mask entries differ from the "
          f"chain, largest relative margin {worst:.3g}; "
          f"{int(got.sum())} survive")
    assert worst <= CULL_THRESHOLD_REL


@pytest.fixture(scope="module")
def bounce2():
    """multimesh515k.c1080's scene as the port builds it
    (`test_torch_cull.config_scene`) with its materials' reflectivity, on
    the card: ``(config, data, clusters, poses)``, the poses those of the
    bounce2 traffic's orbit."""
    dev = _card()
    config, data, accel = config_scene("multimesh515k.c1080", dev)
    data = data._replace(reflectivity=torch.tensor(
        [m["reflectivity"] for m in config["materials"]],
        dtype=torch.float32, device=dev))
    pos = data.positions.cpu().numpy()
    lo, hi = pos.min(0), pos.max(0)
    poses = list(orbit("bounce2", (lo + hi) / 2,
                       config["meshes"][0]["radius"],
                       float((hi - lo).max())))
    return config, data, accel, poses


def bounce2_frame(bounce2, k: int) -> torch.Tensor:
    """Pose ``k``'s frame: two bounces with shadows at 1920x1080 through
    `render_bounces`, as the bounce2 cell renders it."""
    config, data, accel, poses = bounce2
    dev = data.positions.device
    eye, orient = (torch.as_tensor(x, device=dev) for x in poses[k])
    w, h = config["width"], config["height"]
    dirs = rotate_rays(camera_ray_grid(w, h, device=dev), orient)
    return render_bounces(accel, data, eye, dirs, h, w, CONFIG,
                          num_bounces=2, light_dir=tuple(config["light_dir"]),
                          with_shadows=config["shadows"],
                          background=tuple(config["background"]))


@pytest.mark.card
@pytest.mark.parametrize("unit", ["bounce_frame", "ray_bundle"])
def test_one_launch_per_general_cull_on_the_card(bounce2, unit):
    """A bounce frame culls once a bounce, a `trace_rays` bundle once."""
    config, data, accel, poses = bounce2
    dev = data.positions.device
    if unit == "bounce_frame":
        def run():
            return bounce2_frame(bounce2, 0)
    else:
        rng = np.random.default_rng(3)
        origins = torch.from_numpy(rng.uniform(
            -2.0, 2.0, (5000, 3)).astype(np.float32)).to(dev)
        dirs = torch.nn.functional.normalize(torch.from_numpy(rng.normal(
            size=(5000, 3)).astype(np.float32)).to(dev), dim=1)
        blocks = tsweep.segment_blocks(accel)

        def run():
            return tbounce.trace_rays(accel, blocks, origins, dirs)
    run()
    torch.cuda.synchronize()
    tsweep.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    assert tsweep.launch_counts["general_cull"] == (
        2 if unit == "bounce_frame" else 1)


@pytest.mark.card
def test_bounce_frames_equal_the_chains(bounce2, monkeypatch):
    """Two poses of bounce2's orbit, each rendered with the general cull on
    the kernel and on the chain (the other culls and sweeps on their
    kernels), bit for bit; every kernel mask through `cull_gate`."""
    kernel = tbounce._general_cull_cuda
    masks = []

    def recorded(*args):
        got = kernel(*args)
        masks.append((got, args))
        return got

    for k in (0, len(bounce2[3]) // 2):
        monkeypatch.setattr(tbounce, "_general_cull_cuda", recorded)
        got = bounce2_frame(bounce2, k)
        monkeypatch.setattr(tbounce, "_general_cull_cuda",
                            tbounce._general_cull_plain)
        want = bounce2_frame(bounce2, k)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            f"pose {k}: {int((got != want).any(dim=1).sum())} pixels differ"
    assert len(masks) == 4
    for i, (got, args) in enumerate(masks):
        want = tbounce._general_cull_plain(*args)
        differ, worst = cull_gate(got, want,
                                  *(x.cpu().numpy() for x in args))
        print(f"bounce frame cull {i}: {differ} of {got.numel()} mask "
              f"entries differ from the chain, largest relative margin "
              f"{worst:.3g}; {int(args[2].sum())} active rays, "
              f"{int(got.sum())} survive")
        assert worst <= CULL_THRESHOLD_REL
