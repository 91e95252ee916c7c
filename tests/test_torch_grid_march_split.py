"""Kernel M's warp-shared design (`csrc/grid.cu:march_kernel`) replayed in
numpy on the CPU, its staged eye terms (`grid_march.eye_rows`), the warp
hints of `trace_grid`, and the plain march's count of the warps' work.

The kernel runs only on the card (`chip_smoke.py` phase 39 holds it
against `_march_plain` there).  Here `split_march` replays its schedule
lane by lane: warps of 32 consecutive rays or 8x4 pixel patches (lanes
outside the frame march nothing), each step's testing lanes grouped by
bucket (the lowest pending lane's bucket and the lanes that share it), a
group's rows read 32 at a time, one a lane, each tested against every ray
of the group in turn, and a round's winner the least (ordered t, lane)
taken on a strict ``<``.  It must equal `_march_plain` and `march_serial`
exactly (slots equal, t/u/v bitwise) on every case of
`test_torch_grid_march.py`, on a ragged frame, on exact-t ties inside one
bucket, with negative t, and at small caps.  Float32 arithmetic in numpy
rounds each operation once, as the kernel built with ``-fmad=false``
does.
"""

import functools

import numpy as np
import pytest
import torch

from test_grid import _mesh
from test_torch_bvh import assert_hits_match
from test_torch_grid_march import (CASES, cloud_rays, march_serial,
                                   mt_serial, run_both)

from raytracercuda_torch.accel.grid import build_grid
from raytracercuda_torch.config import GridConfig, TraceConfig
from raytracercuda_torch.trace import grid_march
from raytracercuda_torch.types import FLT_MAX

F32 = np.float32
MISS = F32(FLT_MAX)
# Kernel M's warps a block (`csrc/grid.cu:kMarchWarps`).
WARPS = 2


def warp_lanes(num_rays, frame_hw=None):
    """``[warps, 32]`` ray of each lane, -1 for a lane outside the rays:
    32 consecutive rays a warp, or 8x4 pixel patches of a row-major
    ``(H, W)`` frame, patches row-major."""
    if frame_hw is None:
        lanes = np.arange(-(-num_rays // 32) * 32)
        return np.where(lanes < num_rays, lanes, -1).reshape(-1, 32)
    height, width = frame_hw
    out = []
    for wy in range(-(-height // 4)):
        for wx in range(-(-width // 8)):
            y = wy * 4 + np.arange(32) // 8
            x = wx * 8 + np.arange(32) % 8
            out.append(np.where((y < height) & (x < width), y * width + x,
                                -1))
    return np.array(out)


def fletcher16(h):
    s1 = s2 = np.zeros_like(h)
    for k in range(4):
        s1 = (s1 + ((h >> (8 * k)) & 0xFF)) % 255
        s2 = (s2 + s1) % 255
    return (s2 << 8) | s1


def nan_min(a, b):
    return np.where((a < b) | np.isnan(a), a, b)


def nan_max(a, b):
    return np.where((a > b) | np.isnan(a), a, b)


def lane_mt(rows, o, d, use_eps, t_eps):
    """`csrc/mt.cuh:tri_mt` of rays against rows (``[..., 12]``), each of
    ``o`` and ``d`` a sequence of three arrays, broadcast: t (FLT_MAX on a
    miss), u, v."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = np.moveaxis(
        rows[..., :9], -1, 0)
    ox, oy, oz = o
    dx, dy, dz = d
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = F32(1.0) / det
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    return _misses(t, u, v, use_eps, t_eps)


def lane_eye_mt(table, d, use_eps, t_eps):
    """`csrc/mt.cuh:eye_mt` of rays against staged rows (``[..., 16]``,
    `grid_march.eye_rows`), broadcast as `lane_mt`'s."""
    e1x, e1y, e1z, e2x, e2y, e2z, tvx, tvy, tvz, qvx, qvy, qvz, tq = \
        np.moveaxis(table[..., :13], -1, 0)
    dx, dy, dz = d
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = F32(1.0) / det
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    return _misses(tq * inv, u, v, use_eps, t_eps)


def _misses(t, u, v, use_eps, t_eps):
    """The oracle's miss rule, in the order of its early exits."""
    miss = ~((u >= 0) & (u <= 1))
    miss |= ~((v >= 0) & (u + v <= 1))
    miss |= np.isnan(t)
    if use_eps:
        miss |= t < t_eps
    return np.where(miss, MISS, t).astype(F32), u, v


def ordered(t):
    """`csrc/hit_key.cuh:hit_key`'s high word: t's bits in an unsigned
    order over every non-NaN float, -0.0 as +0.0."""
    b = t.view(np.uint32).astype(np.uint64)
    b = np.where(b == 0x80000000, 0, b)
    return np.where(b & 0x80000000, b ^ 0xFFFFFFFF, b ^ 0x80000000)


def split_march(args, record=None):
    """Kernel M's schedule on `grid_march.march_args` output ``args``
    (hints included), with ``WARPS`` warps a block: ``(t, u, v, slot)``
    numpy arrays.  With a ``record`` list, appends for each block-step
    ``(step, rays, buckets, counts, groups)``: its marching lanes' rays,
    buckets and capped counts, and each group's ``(rays, count)``."""
    (rows, cell_start, num_cells, cell_res, pinch, origin, direction,
     max_iters, max_faces, t_eps, frame_hw, common_origin) = args
    eye = common_origin is not None
    table = (grid_march.eye_rows(rows, common_origin) if eye
             else rows).numpy()
    o_all = (np.broadcast_to(common_origin.numpy(), origin.shape) if eye
             else origin.numpy())
    d_all = direction.numpy()
    n = d_all.shape[0]
    out = np.zeros((3, n), F32)
    slots = np.zeros(n, np.int32)
    with np.errstate(all="ignore"):
        _march_blocks(warp_lanes(n, frame_hw), o_all, d_all, table,
                      cell_start.numpy().astype(np.int64), num_cells,
                      F32(cell_res), F32(pinch), max_iters, max_faces, eye,
                      t_eps, out, slots, record)
    return out[0], out[1], out[2], slots


def _march_blocks(rays, o_all, d_all, table, cs, num_cells, res, pinch,
                  max_iters, max_faces, eye, t_eps, out, slots, record):
    """The blocks of `split_march`, ``rays`` ``[blocks, 32]`` (-1 outside),
    stepped together (each lane's march is its own, and every warp of a
    block steps it the same); each block-step's groups in turn, their
    rounds dealt to the block's warps, each warp keeping its own best a
    ray; at the end the least (ordered t, slot) over the warps."""
    use_eps = t_eps is not None
    t_eps = F32(0.0 if t_eps is None else t_eps)
    num_rows = table.shape[0]
    lane = np.arange(32)
    valid = rays >= 0
    idx = np.where(valid, rays, 0)
    o, d = o_all[idx].astype(F32), d_all[idx].astype(F32)  # [blocks, 32, 3]
    inv = F32(1.0) / d
    p = o.copy()
    best = (len(rays), WARPS, 32)
    bt = np.full(best, MISS, F32)
    bu, bv = np.zeros(best, F32), np.zeros(best, F32)
    bs = np.zeros(best, np.int64)
    hit_step = np.full(rays.shape, max_iters)
    marching = valid.copy()
    for step in range(max_iters):
        if not marching.any():
            break
        c = np.where(marching[..., None], np.floor(p / res), 0).astype(
            np.int64)
        h = fletcher16(c & 0xFFFFFFFF).sum(axis=-1) % num_cells
        start = cs[h]
        count = np.minimum(cs[h + 1] - start, max_faces)
        tests = marching & (count > 0)
        for k in np.flatnonzero(marching.any(axis=1)):
            if record is not None:
                m = marching[k]
                record.append((step, rays[k, m], h[k, m], count[k, m], []))
            pending = tests[k].copy()
            unit = step
            while pending.any():
                leader = int(np.argmax(pending))
                gstart, gcount = int(start[k, leader]), int(count[k, leader])
                group = tests[k] & (h[k] == h[k, leader])
                pending &= ~group
                if record is not None:
                    record[-1][4].append((rays[k, group], gcount))
                for base in range(0, gcount, 32):
                    w = unit % WARPS
                    unit += 1
                    has = base + lane < gcount
                    slot = np.clip(gstart + base + lane, 0, num_rows - 1)
                    # Each lane's row against each ray of the group (the
                    # rays on the first axis, the lanes on the second).
                    r = np.flatnonzero(group)
                    rows = table[slot][None]
                    rd = d[k, r].T[..., None]
                    if eye:
                        t, u, v = lane_eye_mt(rows, rd, use_eps, t_eps)
                    else:
                        t, u, v = lane_mt(rows, o[k, r].T[..., None], rd,
                                          use_eps, t_eps)
                    t = np.where(has, t, MISS)
                    hit = t < MISS
                    ord_t = np.where(hit, ordered(t), 0xFFFFFFFF)
                    win = np.argmax(
                        ord_t == ord_t.min(axis=1, keepdims=True), axis=1)
                    j = np.arange(r.size)
                    tw = t[j, win]
                    better = hit[j, win] & (tw < bt[k, w, r])
                    r, win = r[better], win[better]
                    bt[k, w, r], bs[k, w, r] = tw[better], slot[win]
                    bu[k, w, r] = u[better, win]
                    bv[k, w, r] = v[better, win]
                    hit_step[k, r] = step
        step_on = marching & (hit_step > step)
        lo = c.astype(F32) * res
        ta = (lo - p) * inv
        tb = ((lo + res) - p) * inv
        near = nan_min(ta, tb)
        far = nan_max(ta, tb)
        t_near = nan_max(nan_max(near[..., 0], near[..., 1]), near[..., 2])
        t_far = nan_min(nan_min(far[..., 0], far[..., 1]), far[..., 2])
        box_d = np.where(np.isinf(t_near) | (t_near < 0), t_far, t_near)
        nxt = p + d * (box_d + pinch)[..., None]
        step_on &= np.isfinite(nxt).all(axis=-1)
        p = np.where(step_on[..., None], nxt, p)
        marching = step_on
    # The least (ordered t, slot) over each ray's warps.
    key = np.where(bt < MISS, (ordered(bt) << np.uint64(32))
                   | bs.astype(np.uint64), np.uint64(2 ** 64 - 1))
    w = np.argmin(key, axis=1)[:, None]
    t, u, v, s = (np.take_along_axis(x, w, axis=1)[:, 0]
                  for x in (bt, bu, bv, bs))
    miss = t == MISS
    u, v, s = np.where(miss, 0, u), np.where(miss, 0, v), np.where(miss, 0, s)
    out[0, rays[valid]] = t[valid]
    out[1, rays[valid]] = u[valid]
    out[2, rays[valid]] = v[valid]
    slots[rays[valid]] = s[valid]


def assert_bit_equal(got, want):
    """``(t, u, v, slot)`` numpy or torch: slots equal, t/u/v bitwise."""
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def common_origin_of(o):
    """The rays' common origin as a ``[3]`` tensor, or None."""
    return torch.from_numpy(o[0].copy()) if (o == o[0]).all() else None


def frame_of(num_rays):
    """A frame shape ``(H, W)`` for ``num_rays`` rays, W the largest
    divisor up to the square root's double (ragged against 8x4 patches for
    the cases here)."""
    w = max(k for k in range(1, int(2 * num_rays ** 0.5) + 1)
            if num_rays % k == 0)
    return num_rays // w, w


def frame_rays(height, width, spread=0.12):
    """A pinhole frame from (0, 0, -1) over `_mesh`'s cloud, row-major."""
    ys, xs = np.meshgrid(np.linspace(-spread, spread, height),
                         np.linspace(-spread, spread, width), indexing="ij")
    d = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    o = np.broadcast_to(np.array([0, 0, -1.0]), d.shape)
    return o.astype(F32), d.astype(F32)


def doubled_mesh():
    """`_mesh`'s cloud with every face twice (ids f and f + 60): equal
    rows in one bucket, whose t ties exactly."""
    pos, faces = (np.array(x) for x in _mesh(60, seed=12))
    return pos, np.concatenate([faces, faces])


# name: (scene, rays, GridConfig keywords, clip_backward_hits); beside
# `test_torch_grid_march.CASES`.
SPLIT_CASES = {
    "ragged_frame": (lambda: _mesh(60, seed=12),
                     lambda: frame_rays(13, 19), {}, True),
    "doubled_ties": (doubled_mesh, lambda: cloud_rays(300, 12), {}, True),
    # Buckets of more than 32 entries: a face and its twin in different
    # rounds, which two warps may test.
    "doubled_coarse": (doubled_mesh, lambda: cloud_rays(300, 12),
                       dict(cell_res=0.1, num_cells=97), True),
    "negative_t": (lambda: _mesh(60, seed=12),
                   lambda: (np.broadcast_to(np.array([0, 0, 0.05], F32),
                                            (200, 3)).copy(),
                            np.random.default_rng(4).normal(
                                size=(200, 3)).astype(F32)), {}, False),
    "caps_4_40": (lambda: _mesh(60, seed=12), lambda: cloud_rays(300, 12),
                  dict(max_faces_per_cell=4, max_search_iters=40), True),
}


@functools.cache
def jax_run(case):
    """`test_torch_grid_march.run_both` of a case, once."""
    return run_both(case)


@functools.cache
def case_inputs(case):
    """``(grid, positions, faces, o, d, cfg, trace_cfg)`` of a case of
    either table, on the CPU."""
    if case in CASES:
        return jax_run(case)[2]
    scene, rays, kw, clip = SPLIT_CASES[case]
    pos, faces = (np.array(x) for x in scene())
    o, d = rays()
    tp, tf = torch.from_numpy(pos), torch.from_numpy(faces.astype(np.int64))
    cfg = GridConfig(**kw)
    return (build_grid(tp, tf, cfg), tp, tf, o, d, cfg,
            TraceConfig(clip_backward_hits=clip))


@functools.cache
def references(case):
    """`_march_plain` on a case's rays, and `march_serial` on its first 48
    (the hints change neither)."""
    tg, tp, tf, o, d, cfg, tc = case_inputs(case)
    args = grid_march.march_args(tg, tp, tf, torch.from_numpy(o),
                                 torch.from_numpy(d), cfg, tc)
    part = grid_march.march_args(tg, tp, tf, torch.from_numpy(o[:48]),
                                 torch.from_numpy(d[:48]), cfg, tc)
    return grid_march._march_plain(*args), march_serial(*part)


def modes_of(case):
    """Row warps with the general test; pixel patches with it, and from
    the staged eye where the rays share their origin."""
    o, _ = (CASES[case][1] if case in CASES else SPLIT_CASES[case][1])()
    common = common_origin_of(o) is not None
    return ["rows", "patch"] + (["patch+eye"] if common else [])


ALL_CASES = sorted(CASES) + sorted(SPLIT_CASES)
RUNS = [(case, mode) for case in ALL_CASES for mode in modes_of(case)]


@pytest.mark.parametrize("case, mode", RUNS)
def test_split_march_equals_plain(case, mode):
    """The replayed schedule equals `_march_plain` on every ray and
    `march_serial` on the first 48, bit for bit."""
    tg, tp, tf, o, d, cfg, tc = case_inputs(case)
    frame = frame_of(d.shape[0]) if mode.startswith("patch") else None
    eye = common_origin_of(o) if mode.endswith("eye") else None
    args = grid_march.march_args(tg, tp, tf, torch.from_numpy(o),
                                 torch.from_numpy(d), cfg, tc, frame, eye)
    split = split_march(args)
    plain, serial = references(case)
    assert_bit_equal(split, plain)
    assert_bit_equal([x[:48] for x in split], serial)
    t = split[0]
    if case == "negative_t":
        assert (t < 0).any() and (t < MISS).sum() > 20
    if case.startswith("doubled"):
        # Each hit's twin row ties its t exactly; the lower CSR slot wins.
        rows, cs = args[0].numpy(), args[1].numpy()
        slot = split[3][t < MISS]
        assert slot.size > 20
        for s in slot:
            b = int(np.searchsorted(cs, s, side="right")) - 1
            last = min(cs[b + 1], cs[b] + cfg.max_faces_per_cell)
            same = [j for j in range(cs[b], last)
                    if (rows[j] == rows[s]).all()]
            assert len(same) >= 2 and min(same) == s
    if frame is not None and case == "ragged_frame":
        assert frame == (13, 19)


@pytest.mark.parametrize("use_eps", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_eye_rows_test_is_the_oracle(seed, use_eps):
    """The staged test (`mt.cuh:eye_mt` on `eye_rows`) gives the oracle's
    t, u and v bit for bit on random faces and rays from one eye, hits
    and misses both; the table is built once per (rows, eye) and again
    after the eye changes in place."""
    rng = np.random.default_rng(seed)
    n = 256
    eye = rng.normal(size=3).astype(F32)
    v0 = (eye + rng.normal(size=(n, 3)) * 2).astype(F32)
    e1 = (rng.normal(size=(n, 3)) * 0.5).astype(F32)
    e2 = (rng.normal(size=(n, 3)) * 0.5).astype(F32)
    e1[:8] = 0  # det 0: NaN u, a miss
    rows = torch.from_numpy(np.concatenate(
        [v0, e1, e2, np.zeros((n, 3), F32)], axis=1))
    eye_t = torch.from_numpy(eye)
    table = grid_march.eye_rows(rows, eye_t)
    assert tuple(table.shape) == (n, 16)
    assert grid_march.eye_rows(rows, eye_t) is table
    # Rays through random points of each face, and some past it.
    bary = rng.uniform(0, 1, (n, 2)).astype(F32) * F32(0.9)
    bary[rng.uniform(size=n) < 0.3] *= F32(3)
    target = v0 + bary[:, :1] * e1 + bary[:, 1:] * e2
    d = (target - eye).astype(F32)
    t_eps = F32(0.5) if use_eps else F32(0)
    hits = 0
    np.seterr(all="ignore")
    for k in range(0, n, 32):
        lanes = table.numpy()[k:k + 32]
        for r in range(k, k + 32):
            t, u, v = lane_eye_mt(lanes, d[r], use_eps, t_eps)
            for j in range(32):
                wt, wu, wv = mt_serial(rows.numpy()[k + j], list(eye),
                                       list(d[r]), use_eps, t_eps)
                assert t[j].view(np.int32) == F32(wt).view(np.int32)
                if wt < MISS:
                    hits += 1
                    assert u[j].view(np.int32) == F32(wu).view(np.int32)
                    assert v[j].view(np.int32) == F32(wv).view(np.int32)
    np.seterr(all="warn")
    assert hits >= 100
    eye_t += 1.0
    moved = grid_march.eye_rows(rows, eye_t)
    assert moved is not table
    assert torch.equal(moved[:, 6:9], eye_t - rows[:, 0:3])


def test_eye_rows_cache_keys_on_the_eyes_bits():
    """`eye_rows` is built once per (rows, the eye's bits): another tensor
    with the same eye (a detached copy, as `render_rgb` passes) takes the
    cached table, and an eye that differs only in a zero's sign does not."""
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.normal(size=(40, 12)).astype(F32))
    eye = torch.tensor([0.0, 0.5, -2.0], requires_grad=True)
    table = grid_march.eye_rows(rows, eye.detach())
    assert grid_march.eye_rows(rows, eye.detach().clone()) is table
    assert grid_march.eye_rows(rows, eye) is table
    signed = grid_march.eye_rows(rows, torch.tensor([-0.0, 0.5, -2.0]))
    assert signed is not table
    assert torch.equal(signed[:, 6:9], torch.tensor([-0.0, 0.5, -2.0])
                       - rows[:, 0:3])


HINT_CASES = [case for case in sorted(CASES)
              if common_origin_of(CASES[case][1]()[0]) is not None]


@pytest.mark.parametrize("case", HINT_CASES)
def test_trace_grid_hints_keep_the_hit(case):
    """`trace_grid` with ``frame_hw`` and ``common_origin`` returns the
    same `Hit` as without, and both equal JAX's `trace_grid`."""
    got, want, (tg, tp, tf, o, d, cfg, tc) = jax_run(case)
    hinted = grid_march.trace_grid(
        tg, tp, tf, torch.from_numpy(o), torch.from_numpy(d), cfg, tc,
        frame_hw=frame_of(d.shape[0]), common_origin=common_origin_of(o))
    for a, b in zip(got, hinted):
        assert torch.equal(a, b)
    assert_hits_match(hinted, want, min_hits=CASES[case][4])
    with pytest.raises(ValueError, match="frame_hw"):
        grid_march.trace_grid(tg, tp, tf, torch.from_numpy(o),
                              torch.from_numpy(d), cfg, tc,
                              frame_hw=(d.shape[0] + 1, 1))


@pytest.mark.parametrize("case", ALL_CASES)
def test_trace_grid_rejects_a_wrong_common_origin(case):
    """A ``common_origin`` that is not every ray's origin bit for bit
    raises ValueError (on either device: `march_args` checks it): the
    first origin moved by one ulp, with a zero's sign flipped, as a
    ``[1, 3]`` tensor, or, where the origins differ, the first one."""
    tg, tp, tf, o, d, cfg, tc = case_inputs(case)
    first = o[0].astype(F32)
    with np.errstate(under="ignore"):  # a zero moves to a subnormal
        wrong = [np.nextafter(first, F32(np.inf)).astype(F32)]
    zero = np.flatnonzero(first == 0)
    if zero.size:
        flipped = first.copy()
        flipped[zero] = -flipped[zero]
        wrong.append(flipped)
    if common_origin_of(o) is None:
        wrong.append(first)
    for w in wrong:
        with pytest.raises(ValueError, match="common_origin"):
            grid_march.trace_grid(tg, tp, tf, torch.from_numpy(o),
                                  torch.from_numpy(d), cfg, tc,
                                  common_origin=torch.from_numpy(w))
    if common_origin_of(o) is not None:
        with pytest.raises(ValueError, match="common_origin"):
            grid_march.march_args(tg, tp, tf, torch.from_numpy(o),
                                  torch.from_numpy(d), cfg, tc, None,
                                  torch.from_numpy(first[None]))


def direct_counts(record, num_rays, frame_hw):
    """The warps' work counted from the replay's record of each ray's
    (step, bucket, count), regrouped by `warp_lanes`: for each warp shape
    the sum over warp-steps of the largest bucket and of the distinct
    buckets' counts; the rounds of 32 rows each ray takes."""
    visits = [(step, int(r), int(b), int(c)) for step, rays, hs, cs, _ in
              record for r, b, c in zip(rays, hs, cs)]
    shapes = {"row": None, **({} if frame_hw is None
                              else {"patch": frame_hw})}
    serial, shared = {}, {}
    for name, hw in shapes.items():
        warp_of = {int(r): w for w, rays in enumerate(
            warp_lanes(num_rays, hw)) for r in rays if r >= 0}
        longest, distinct = {}, {}
        for step, r, b, c in visits:
            key = (warp_of[r], step)
            longest[key] = max(longest.get(key, 0), c)
            distinct[key + (b,)] = c
        serial[name] = sum(longest.values())
        shared[name] = sum(distinct.values())
    tests = sum(c for *_, c in visits)
    rounds = sum(-(-c // 32) for *_, c in visits)
    return tests, serial, shared, rounds


@pytest.mark.parametrize("frame", [(13, 19), (12, 40)])
def test_tally_counts_warp_work(frame):
    """The plain march's counters (`_tally_step`, `_tally_done`) on a
    small frame equal a direct count over the replay's record: lane use
    of one thread a ray on row and patch warps, rows read when a
    warp-step reads each distinct bucket once, and lane use of the shared
    schedule.  The replay's groups take exactly those rounds."""
    tg, tp, tf, _, _, cfg, tc = case_inputs("ragged_frame")
    o, d = frame_rays(*frame)
    args = grid_march.march_args(tg, tp, tf, torch.from_numpy(o),
                                 torch.from_numpy(d), cfg, tc, frame,
                                 torch.from_numpy(o[0].copy()))
    record = []
    split_march(args, record=record)
    tally = {}
    grid_march._march_plain(*args, tally=tally)
    n = d.shape[0]
    tests, serial, shared, rounds = direct_counts(record, n, frame)
    assert tally["tests"] == tests > 0
    assert tally["shared_rows"] == shared
    assert 0 < min(shared.values()) <= max(shared.values()) < tests
    assert tally["serial_lane_use"] == {
        k: tests / (32 * v) for k, v in serial.items()}
    assert tally["shared_lane_use"] == tests / (32 * rounds)
    group_rounds = sum(len(rays) * -(-c // 32) for *_, groups in record
                       for rays, c in groups)
    assert group_rounds == rounds
    for name, hw in (("row", None), ("patch", frame)):
        warps = grid_march.block_of_rays(n, hw).numpy()
        lanes = warp_lanes(n, hw)
        assert grid_march.num_blocks(n, hw) == lanes.shape[0]
        for w, rays in enumerate(lanes):
            assert (warps[rays[rays >= 0]] == w).all()
