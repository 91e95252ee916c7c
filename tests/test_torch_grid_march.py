"""The port's grid march (`raytracercuda_torch.trace.grid_march`, kernel M's
plain version) against the JAX package's `trace_grid`, and the march
replayed one ray at a time, on the CPU.

Tolerances, stated per check:

  * face ids equal; t, u and v within 1e-5 relative and 5e-5 absolute
    (XLA on the CPU contracts multiply-adds, in the tests and in the
    step's advance; the port does not);
  * `box_ray_intersect_no_zero`: bitwise equal to JAX's (one subtraction
    and one product a slab, nothing to contract), and NaN exactly where
    JAX's is (a zero direction component times a zero offset);
  * `march_serial`, the march one ray at a time with its bucket's faces
    in series (a transcription of `Hash.cu`'s per-ray loop and of
    `csrc/mt.cuh`'s test) in numpy float32 scalars: bit-equal to
    `_march_plain` (slots equal, t/u/v bitwise).  Kernel M runs only on
    the card (`chip_smoke.py` phase 39 holds it against `_march_plain`
    there); `test_torch_grid_march_split.py` replays its warp-shared
    schedule against both here.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (checks the port imports no jax first)
from test_grid import _mesh
from test_torch_bvh import assert_hits_match

import jax.numpy as jnp

from raytracercuda_tpu.accel.grid import build_grid as jax_build
from raytracercuda_tpu.config import GridConfig as JaxGridConfig
from raytracercuda_tpu.config import TraceConfig as JaxTraceConfig
from raytracercuda_tpu.ops.math import box_ray_intersect_no_zero as jax_box
from raytracercuda_tpu.trace.grid_march import trace_grid as jax_trace

from raytracercuda_torch.accel.grid import build_grid
from raytracercuda_torch.config import GridConfig, TraceConfig
from raytracercuda_torch.ops.math import box_ray_intersect_no_zero
from raytracercuda_torch.trace import grid_march
from raytracercuda_torch.trace.bruteforce import trace_brute
from raytracercuda_torch.types import FLT_MAX

F32 = np.float32


def collision_scene():
    """`tests/test_grid.py:112`'s scene: a near face in cell (0,0,100) and
    a far face in cell (0,0,255), whose bucket is cell (0,0,0)'s."""
    def tri_at(z):
        return np.array([[0.002, 0.002, z], [0.028, 0.002, z],
                         [0.015, 0.028, z]], np.float32)

    pos = np.concatenate([tri_at(100 * F32(0.03) + F32(0.0015)),
                          tri_at(255 * F32(0.03) + F32(0.0015))])
    faces = np.array([[0, 1, 2, 0], [3, 4, 5, 0]], np.int32)
    return pos, faces


def cloud_rays(n, seed):
    """``n`` rays from (0, 0, -1) aimed into `_mesh`'s cloud
    (`tests/test_grid.py:73`)."""
    rng = np.random.default_rng(seed)
    origin = np.broadcast_to(np.array([0, 0, -1.0], np.float32), (n, 3))
    return origin.copy(), rng.uniform(-0.12, 0.12, (n, 3)).astype(
        np.float32) - origin


def inside_rays(n, seed):
    """Rays from inside the cloud in every direction, a few of them along
    an axis or with zero components."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.15, 0.15, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:6] = [[0, 0, 1], [1, 0, 0], [0, -1, 0], [0.5, 0, 0.5], [0, 0.3, -1],
             [-1, 0, 0]]
    return o, d


def axis_rays():
    """Axis-aligned rays and rays with zero components, some from points
    on cell boundaries (0 * inf in the slab test)."""
    o = np.array([[0.015, 0.012, 0.0005], [0.0, 0.0, -1.0], [0.03, 0.06, -1],
                  [0.03, -0.09, 0.0], [-0.2, 0.0, 0.0], [0.0, -0.2, 0.03]],
                 np.float32)
    d = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 0], [1, 0, 0],
                  [0, 1, 0]], np.float32)
    return o, d


# name: (scene, rays, GridConfig keywords, clip_backward_hits, min hits)
CASES = {
    "cloud": (lambda: _mesh(60, seed=12), lambda: cloud_rays(300, 12), {},
              True, 20),
    "cloud_caps": (lambda: _mesh(60, seed=12), lambda: cloud_rays(300, 12),
                   dict(max_faces_per_cell=2, max_search_iters=40,
                        max_cells_per_face=4), True, 5),
    "cloud_coarse": (lambda: _mesh(60, seed=12), lambda: cloud_rays(300, 12),
                     dict(cell_res=0.1, num_cells=97, max_faces_per_cell=4),
                     True, 10),
    "inside_clip": (lambda: _mesh(60, seed=12), lambda: inside_rays(200, 3),
                    {}, True, 5),
    "inside_no_clip": (lambda: _mesh(60, seed=12),
                       lambda: inside_rays(200, 3), {}, False, 5),
    "miss": (lambda: _mesh(10, seed=13),
             lambda: (np.full((4, 3), 5.0, np.float32),
                      np.tile(np.array([[1.0, 0, 0]], np.float32), (4, 1))),
             {}, True, 0),
    "collision": (collision_scene, axis_rays, {}, True, 1),
}


def run_both(case):
    scene, rays, kw, clip, _ = CASES[case]
    pos, faces = (np.array(x) for x in scene())
    o, d = rays()
    jcfg = JaxGridConfig(**kw)
    jg = jax_build(jnp.asarray(pos), jnp.asarray(faces), jcfg)
    want = jax_trace(jg, jnp.asarray(pos), jnp.asarray(faces),
                     jnp.asarray(o), jnp.asarray(d), jcfg,
                     JaxTraceConfig(clip_backward_hits=clip))
    tp, tf = torch.from_numpy(pos), torch.from_numpy(faces.astype(np.int64))
    cfg = GridConfig(**kw)
    tg = build_grid(tp, tf, cfg)
    tc = TraceConfig(clip_backward_hits=clip)
    got = grid_march.trace_grid(tg, tp, tf, torch.from_numpy(o),
                                torch.from_numpy(d), cfg, tc)
    return got, want, (tg, tp, tf, o, d, cfg, tc)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_grid_matches_jax(case):
    got, want, _ = run_both(case)
    assert got.face.dtype == torch.int32
    assert_hits_match(got, want, min_hits=CASES[case][4])


def test_collision_surfaces_far_face():
    """The hash collision of `tests/test_grid.py:112`: the ray standing in
    cell (0,0,0) reports the far face (bucket 0), not the near one that
    brute force finds, with the far face's genuine t."""
    got, _, (tg, tp, tf, o, d, *_) = run_both("collision")
    brute = trace_brute(tp, tf, torch.from_numpy(o), torch.from_numpy(d))
    assert int(brute.face[0]) == 0 and int(got.face[0]) == 1
    np.testing.assert_allclose(float(got.t[0]),
                               255 * 0.03 + 0.0015 - 0.0005, rtol=1e-5)


def test_origin_broadcast_and_brute_agreement():
    """A ``[3]`` origin broadcasts as in JAX; every hit of the brute force
    through the cloud is found, with the same t where the faces agree
    (`tests/test_grid.py:67`)."""
    pos, faces = _mesh(60, seed=12)
    o, d = cloud_rays(300, 12)
    tp = torch.from_numpy(np.array(pos))
    tf = torch.from_numpy(np.array(faces, np.int64))
    tg = build_grid(tp, tf)
    full = grid_march.trace_grid(tg, tp, tf, torch.from_numpy(o),
                                 torch.from_numpy(d))
    one = grid_march.trace_grid(tg, tp, tf, torch.from_numpy(o[0]),
                                torch.from_numpy(d))
    for a, b in zip(full, one):
        assert torch.equal(a, b)
    brute = trace_brute(tp, tf, torch.from_numpy(o), torch.from_numpy(d))
    assert not (brute.hit_mask & ~full.hit_mask).any()
    same = (full.face == brute.face) & full.hit_mask
    assert torch.equal(full.t[same], brute.t[same])


def test_box_ray_intersect_no_zero_matches_jax():
    rng = np.random.default_rng(8)
    n = 512
    bmin = (rng.integers(-5, 5, (n, 3)) * F32(0.03)).astype(np.float32)
    bmax = (bmin + F32(0.03)).astype(np.float32)
    p = bmin + rng.uniform(0, 0.03, (n, 3)).astype(np.float32)
    p[:64] = bmin[:64]  # on the slab: 0 * inf where d has a zero
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[np.arange(128), rng.integers(0, 3, 128)] = 0.0
    with np.errstate(divide="ignore"):
        inv = (F32(1.0) / d).astype(np.float32)
    got = box_ray_intersect_no_zero(*(torch.from_numpy(x)
                                      for x in (bmin, bmax, p, inv)))
    want = np.asarray(jax_box(*(jnp.asarray(x) for x in (bmin, bmax, p, inv))))
    got = got.numpy()
    nan = np.isnan(want)  # NaN where JAX's is (its sign may differ)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))
    assert nan.any() and np.isfinite(want).sum() > n // 2


# ---------------------------------------------------------------------------
# Kernel M's design, one ray at a time.
# ---------------------------------------------------------------------------


def fletcher16(h: int) -> int:
    s1 = s2 = 0
    for k in range(4):
        s1 = (s1 + ((h >> (8 * k)) & 0xFF)) % 255
        s2 = (s2 + s1) % 255
    return (s2 << 8) | s1


def mt_serial(row, o, d, use_eps, t_eps):
    """`csrc/mt.cuh:oracle_mt` on a v0 | e1 | e2 row, in float32 scalars
    with its terms in its order."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (F32(x) for x in row[:9])
    ox, oy, oz = o
    dx, dy, dz = d
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = F32(1.0) / det
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    if not (u >= 0 and u <= 1):
        return FLT_MAX, u, F32(0)
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    if not (v >= 0 and u + v <= 1):
        return FLT_MAX, u, v
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    if np.isnan(t) or (use_eps and t < t_eps):
        return FLT_MAX, u, v
    return t, u, v


def nan_min(a, b):
    return a if (a < b or np.isnan(a)) else b


def nan_max(a, b):
    return a if (a > b or np.isnan(a)) else b


def march_serial(rows, cell_start, num_cells, cell_res, pinch, origin,
                 direction, max_iters, max_faces, t_eps, frame_hw=None,
                 common_origin=None):
    """Kernel M's march, one ray at a time with its bucket's faces in
    series: ``(t, u, v, slot)`` numpy arrays, as `_march_plain` returns
    them (a ray's result depends on no other ray, so the warp hints of
    `march_args` change nothing)."""
    rows = rows.numpy()
    cs = cell_start.numpy().astype(np.int64)
    res, pinch = F32(cell_res), F32(pinch)
    use_eps = t_eps is not None
    t_eps = F32(0.0 if t_eps is None else t_eps)
    n = direction.shape[0]
    out = np.zeros((3, n), np.float32)
    slots = np.zeros(n, np.int32)
    with np.errstate(all="ignore"):
        for i in range(n):
            o = [F32(x) for x in origin[i].tolist()]
            d = [F32(x) for x in direction[i].tolist()]
            inv = [F32(1.0) / x for x in d]
            p = list(o)
            bt, bu, bv, bs = FLT_MAX, F32(0), F32(0), 0
            for _ in range(max_iters):
                c = [int(np.floor(x / res)) for x in p]
                h = sum(fletcher16(x & 0xFFFFFFFF) for x in c) % num_cells
                start = int(cs[h])
                count = min(int(cs[h + 1]) - start, max_faces)
                for k in range(count):
                    slot = min(max(start + k, 0), rows.shape[0] - 1)
                    t, u, v = mt_serial(rows[slot], o, d, use_eps, t_eps)
                    if t < bt:
                        bt, bu, bv, bs = t, u, v, slot
                if bt < FLT_MAX:
                    break
                lo = [F32(x) * res for x in c]
                ta = [(lo[a] - p[a]) * inv[a] for a in range(3)]
                tb = [((lo[a] + res) - p[a]) * inv[a] for a in range(3)]
                t_near = nan_max(nan_max(nan_min(ta[0], tb[0]),
                                         nan_min(ta[1], tb[1])),
                                 nan_min(ta[2], tb[2]))
                t_far = nan_min(nan_min(nan_max(ta[0], tb[0]),
                                        nan_max(ta[1], tb[1])),
                                nan_max(ta[2], tb[2]))
                box_d = (t_far if (np.isinf(t_near) or t_near < 0)
                         else t_near)
                s = box_d + pinch
                nxt = [p[a] + d[a] * s for a in range(3)]
                if not all(np.isfinite(x) for x in nxt):
                    break
                p = nxt
            out[:, i] = bt, bu, bv
            slots[i] = bs
    return out[0], out[1], out[2], slots


SERIAL_CASES = ("cloud", "cloud_caps", "cloud_coarse", "inside_no_clip",
                "collision")


@pytest.mark.parametrize("case", SERIAL_CASES)
def test_march_serial_equals_plain(case):
    """Kernel M's per-ray loop, bit for bit the plain version's lockstep
    rounds (the first 48 rays of each case)."""
    _, _, (tg, tp, tf, o, d, cfg, tc) = run_both(case)
    args = grid_march.march_args(tg, tp, tf, torch.from_numpy(o[:48]),
                                 torch.from_numpy(d[:48]), cfg, tc)
    plain = grid_march._march_plain(*args)
    serial = march_serial(*args)
    np.testing.assert_array_equal(plain[3].numpy(), serial[3])
    for p, s in zip(plain[:3], serial[:3]):
        np.testing.assert_array_equal(p.numpy().view(np.int32),
                                      s.view(np.int32))
    assert (serial[0] < FLT_MAX).any()


def test_march_rows_and_tally():
    """`march_rows` is built once per (grid, scene) and again after an
    in-place change; the plain version's ``tally`` counts each ray's steps
    and tests as the serial replay takes them."""
    _, _, (tg, tp, tf, o, d, cfg, tc) = run_both("cloud")
    rows = grid_march.march_rows(tg, tp, tf)
    n = int(tg.cell_start[-1])
    assert tuple(rows.shape) == (n, 12)
    assert grid_march.march_rows(tg, tp, tf) is rows
    fid = int(tg.entries[0])
    v = tp[tf[fid, :3]]
    torch.testing.assert_close(rows[0], torch.cat(
        [v[0], v[1] - v[0], v[2] - v[0], torch.zeros(3)]), rtol=0, atol=0)
    tp2 = tp.clone()
    assert grid_march.march_rows(tg, tp2, tf) is not rows
    tp2 += 1.0
    moved = grid_march.march_rows(tg, tp2, tf)
    assert torch.equal(moved[:, 0:3], rows[:, 0:3] + 1.0)
    args = grid_march.march_args(tg, tp, tf, torch.from_numpy(o),
                                 torch.from_numpy(d), cfg, tc)
    tally = {}
    hit = grid_march.slot_hit(tg, *grid_march._march_plain(*args,
                                                            tally=tally))
    steps, tests = tally["ray_steps"], tally["ray_tests"]
    assert tally["steps"] == int(steps.sum()) and tally["tests"] == int(
        tests.sum())
    assert int(steps.min()) >= 1 and int(steps.max()) <= cfg.max_search_iters
    assert int(tests[hit.hit_mask].min()) >= 1
    assert 0 < tally["rows_read"] <= n
    assert 0 < tally["buckets_read"] <= int(tally["touched_buckets"].sum())


def test_kernel_wrapper_rejects_cpu_tensors():
    """A CPU tensor never reaches kernel M: its wrapper checks first."""
    _, _, (tg, tp, tf, o, d, cfg, tc) = run_both("miss")
    args = grid_march.march_args(tg, tp, tf, torch.from_numpy(o),
                                 torch.from_numpy(d), cfg, tc)
    with pytest.raises(ValueError, match="CUDA"):
        grid_march._march_cuda(*args)
