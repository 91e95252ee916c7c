#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`raytracercuda_torch`) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

  1. requires a CUDA device and prints its name and power limit;
  2. builds the CUDA kernels from `raytracercuda_torch/csrc/` (one nvcc
     per source, in parallel) and prints the build time;
  3. renders the bench frame once through `FrameRenderer` (512x512, a
     69,451-triangle bumpy sphere with uvs and a texture, shadows on) and
     requires that kernels A and B both launched in that run;
  4. holds kernel A and kernel B against their plain PyTorch versions on
     the card, on the inputs that frame gave them (A: slots equal, t/u/v
     within 1e-6 relative on hits, attributes within 1e-5; B: equal masks);
  5. renders the same frame with the plain versions on the card and
     requires every u8 channel within 1, hit pixels and shadowed pixels;
  6. times 50 frames on each path and each kernel beside its plain
     version;
  7. builds the config-4 scene at 1024x1024: a 345,944-triangle bumpy
     sphere (the armadillo stand-in) and, standing in for f16.obj, a
     4,056-triangle textured bumpy sphere with a seeded 256x256 texture;
  8. runs `progressive_step` with shadows (warm-up, then three steps) and
     requires that kernels C and H launched;
  9. takes the grad step of `l2_image_loss` over (positions, textures)
     against a zero target and requires finite, nonzero gradients and at
     least two launches of kernel G;
 10. holds C, H and G against their plain versions on the inputs of
     phases 8-9 (C: slots equal, t/u/v within 1e-6 relative on hits; H:
     equal masks; G: |k - p| <= 1e-5 max|p| + 1e-6, and whether two runs
     of G are bitwise equal);
 11. takes the grad step with the plain versions on the card: equal ids,
     shadow masks and images, gradients within G's summation-order bar;
 12. takes five Adam steps (lr 1e-2) on positions and textures from a
     perturbed texture toward the image of the true one, and requires the
     loss after them to be below the loss before them;
 13. times the progressive and grad steps on both paths and C, H and G
     beside their plain versions.

Any failure exits non-zero.  The last two lines of standard output are a
JSON object of the kernels' counts, errors and times, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SIZE = 512
NUM_FACES = 69451  # bunny.obj's triangle count (BASELINE.json)
FRAMES = 50
# Config 4 (scripts/bench_configs.py:116-160): 1024x1024, the armadillo
# stand-in, and a textured stand-in of f16.obj's 4,056 triangles.
C4_SIZE = 1024
C4_ARMADILLO = 345944
C4_F16 = 4056
ADAM_STEPS = 5
REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_cuda(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err_on_hits(x, y, hit, name: str) -> float:
    """Require ``x`` within 1e-6 relative of ``y`` where ``hit``; returns
    the largest absolute difference there."""
    d = (x[hit] - y[hit]).abs()
    check(bool((d <= 1e-6 * y[hit].abs()).all()),
          f"{name}: beyond 1e-6 relative")
    return float(d.max()) if d.numel() else 0.0


class PhaseClock:
    """Prints the seconds each phase took (host clock, after a sync)."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, name: str) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.2f} s")
        self.t = now


class Recorder:
    """Swap a module's functions for ones that remember their arguments
    (every call's) and call through; `restore` puts them back."""

    def __init__(self, module, names):
        self.module = module
        self.real = {n: getattr(module, n) for n in names}
        self.calls = {n: [] for n in names}
        for n, fn in self.real.items():
            setattr(module, n, self._wrap(n, fn))

    def _wrap(self, name, fn):
        def run(*args):
            self.calls[name].append(args)
            return fn(*args)
        return run

    def restore(self):
        for n, fn in self.real.items():
            setattr(self.module, n, fn)


class PlainOnCard:
    """Within it, the CUDA wrappers of the given modules run their plain
    versions: ``{module: {cuda_name: plain_fn}}``."""

    def __init__(self, swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, d in self.swaps.items()
                      for n in d]
        for m, d in self.swaps.items():
            for n, fn in d.items():
                setattr(m, n, fn)

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def config4_scene(dev, armadillo_faces, f16_faces):
    """Config 4's scene (scripts/bench_configs.py:116-136): the armadillo
    stand-in ``bumpy_sphere_mesh(345944, radius=4, center=(0, -1, 14),
    seed=2)`` and, in place of f16.obj (which the repository does not
    ship), a textured bumpy sphere of its 4,056 triangles with a seeded
    256x256 texture; clusters built once; the eye backed off by twice the
    extent (`frame_eye`, :59-64), orient the identity."""
    import numpy as np
    import torch

    from raytracercuda_torch.config import AccelKind, RenderConfig
    from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
    from raytracercuda_torch.models.scene import Material, Scene

    config = RenderConfig(accel=AccelKind.CLUSTER)
    scene = Scene(config, device=dev)
    # As there: material 0 is the scene's default (white, untextured),
    # which the armadillo stand-in keeps; the loaded model's material
    # (here: textured) comes after it.
    f16 = bumpy_sphere_mesh(f16_faces, radius=2.0, center=(2.0, 3.0, 7.0),
                            bump=0.3, seed=7)
    f16.material_id = 1
    scene.add_mesh(f16)
    scene.add_mesh(bumpy_sphere_mesh(armadillo_faces, radius=4.0,
                                     center=(0, -1, 14), seed=2))
    scene.materials = [Material(), Material(texture_id=0)]
    scene.textures = [np.random.default_rng(4).random((256, 256, 3))]
    data = scene.data()
    accel = scene.accel
    lo = data.positions.amin(dim=0)
    hi = data.positions.amax(dim=0)
    extent = float((hi - lo).amax())
    eye = ((lo + hi) / 2 - torch.tensor([0.0, 0.0, 2.0 * extent],
                                        device=dev)).to(torch.float32)
    return config, data, accel, eye, torch.eye(3, device=dev)


def diff_path(dev, clock, card, size=C4_SIZE, armadillo_faces=C4_ARMADILLO,
              f16_faces=C4_F16):
    """Phases 7-13: config 4's progressive step and grad step through
    kernels C, H and G.  Returns the three kernels' JSON records."""
    import numpy as np
    import torch

    from raytracercuda_torch.diff import render_grad, scatter
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.trace import sweep
    from raytracercuda_torch.trace.progressive import (init_progressive,
                                                       progressive_step)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # 7. The config-4 scene.
    config, data, accel, eye, orient = config4_scene(dev, armadillo_faces,
                                                     f16_faces)
    n = size * size
    hw = (size, size)
    print(f"config 4: {data.num_faces} faces -> {accel.num_clusters} "
          f"clusters, {size}x{size}, eye {eye.tolist()}")
    clock.done("7 (scene)")

    # 8. Progressive step, shadows on: warm-up, then three steps.
    def prog(state):
        return progressive_step(state, data, accel, eye, orient, size, size,
                                config, with_shadows=True)

    with torch.no_grad():
        state = prog(init_progressive(n, device=dev))
        sync()
        rec_prog = Recorder(sweep, ["_primary_cuda", "_occlusion_rows_cuda"])
        try:
            sweep.reset_launch_counts()
            for _ in range(3):
                state = prog(state)
            sync()
            prog_launches = dict(sweep.launch_counts)
        finally:
            rec_prog.restore()
    print(f"progressive launches: {prog_launches}")
    check(prog_launches["primary"] > 0, "kernel C never launched")
    check(prog_launches["occlusion_rows"] > 0, "kernel H never launched")
    img = state.image
    check(tuple(img.shape) == (n, 3) and bool(torch.isfinite(img).all()),
          f"progressive image {tuple(img.shape)} not finite")
    check(state.count == 4, f"progressive count {state.count}")
    clock.done("8 (progressive step)")

    # 9. Grad step (config 4's, :140-150): zero target, no shadows.
    rays = camera_ray_grid(size, size, device=dev)
    zero = torch.zeros((n, 3), device=dev)

    def grad_step(textures=None, target=zero, with_shadows=False):
        p = data.positions.detach().clone().requires_grad_()
        t = (data.textures if textures is None else textures).detach() \
            .clone().requires_grad_()
        loss = render_grad.l2_image_loss(
            data._replace(positions=p, textures=t), accel, rays, eye, orient,
            target, config, frame_hw=hw, with_shadows=with_shadows)
        loss.backward()
        return loss.detach(), p.grad, t.grad

    grad_step()  # warm-up
    sync()
    rec_grad = Recorder(scatter, ["_scatter_add_cuda"])
    try:
        sweep.reset_launch_counts()
        scatter.reset_launch_counts()
        loss, gp, gt = grad_step()
        sync()
        grad_launches = {**sweep.launch_counts, **scatter.launch_counts}
    finally:
        rec_grad.restore()
    print(f"grad step launches: {grad_launches}; loss {float(loss):.6g}")
    check(grad_launches["scatter_add"] >= 2,
          "kernel G launched fewer than twice in a backward")
    check(grad_launches["primary"] > 0, "kernel C never launched")
    flags = {"grad_pos_finite": bool(torch.isfinite(gp).all()),
             "grad_pos_nonzero": bool((gp != 0).any()),
             "grad_tex_finite": bool(torch.isfinite(gt).all()),
             "grad_tex_nonzero": bool((gt != 0).any())}
    print(f"grad flags: {flags}")
    check(all(flags.values()), f"grad step flags {flags}")
    clock.done("9 (grad step)")

    # 10. C, H and G against their plain versions on phases 8-9's inputs
    # (the last progressive step's C and H, the grad step's two G calls).
    c_args = rec_prog.calls["_primary_cuda"][-1]
    h_args = rec_prog.calls["_occlusion_rows_cuda"][-1]
    g_calls = rec_grad.calls["_scatter_add_cuda"]
    kc = sweep._primary_cuda(*c_args)
    pc = sweep._primary_plain(*c_args)
    sync()
    check(torch.equal(kc[3], pc[3]), "kernel C: slots differ from plain: "
          f"{int((kc[3] != pc[3]).sum())} rays")
    hit = pc[0] < float(np.float32(3.4028234663852886e38))
    c_err = max(rel_err_on_hits(kc[k], pc[k], hit, f"kernel C plane {k}")
                for k in range(3))  # t, u, v
    print(f"kernel C matches plain: {int(hit.sum())} hit rays of "
          f"{hit.numel()}, max abs err {c_err:.3g}")
    kh = sweep._occlusion_rows_cuda(*h_args)
    ph = sweep._occlusion_rows_plain(*h_args)
    sync()
    check(torch.equal(kh, ph), "kernel H: masks differ from plain: "
          f"{int((kh != ph).sum())} rays")
    h_err = float((kh.int() - ph.int()).abs().max())
    print(f"kernel H matches plain: {int(ph.sum())} occluded of "
          f"{int(h_args[3].sum())} active shadow rays")
    check(int(ph.sum()) > 0, "no shadow ray is occluded")
    g_err = 0.0
    for args in g_calls:
        kg = scatter._scatter_add_cuda(*args)
        kg2 = scatter._scatter_add_cuda(*args)
        pg = scatter._scatter_add_plain(*args)
        sync()
        err = float((kg - pg).abs().max())
        bar = 1e-5 * float(pg.abs().max()) + 1e-6
        check(err <= bar, f"kernel G [{args[0].shape}]: max abs err {err} "
              f"> {bar}")
        g_err = max(g_err, err)
        print(f"kernel G matches plain, g {tuple(args[0].shape)} -> "
              f"{args[2]} rows: max abs err {err:.3g} (bar {bar:.3g}); two "
              f"kernel runs bitwise equal: {torch.equal(kg, kg2)}")
    clock.done("10 (kernels vs plain)")

    # 11. The grad step (and a shadowed render) with the plain versions.
    plain = PlainOnCard({
        sweep: {"_primary_cuda": sweep._primary_plain,
                "_occlusion_rows_cuda": sweep._occlusion_rows_plain},
        scatter: {"_scatter_add_cuda": scatter._scatter_add_plain}})

    def discrete():
        return render_grad._discrete(data, accel, rays, eye, orient, config,
                                     "lambert", True, (0.4, 0.8, -0.45), hw)

    def shadowed():
        with torch.no_grad():
            return render_grad.render_rgb(data, accel, rays, eye, orient,
                                          config, with_shadows=True,
                                          frame_hw=hw)

    k_ids, k_mask = discrete()
    k_img = shadowed()
    with plain:
        p_ids, p_mask = discrete()
        p_img = shadowed()
        p_loss, p_gp, p_gt = grad_step()
    sync()
    check(torch.equal(k_ids, p_ids), "plain path: other hit ids")
    check(torch.equal(k_mask, p_mask), "plain path: other shadow mask")
    img_err = float((k_img - p_img).abs().max())
    check(img_err <= 1e-6, f"plain path: image differs by {img_err}")
    # G sums a row's cotangents with float atomics, in an order that
    # changes from run to run; index_add_ in another.  Each gradient entry
    # is a sum of such rows' entries, so the two agree to float32 rounding
    # of those sums: within 1e-4 of the gradient's largest entry.
    for name, k, p_ in (("positions", gp, p_gp), ("textures", gt, p_gt)):
        err = float((k - p_).abs().max())
        bar = 1e-4 * float(p_.abs().max())
        print(f"plain path grad {name}: max abs diff {err:.3g} (bar "
              f"{bar:.3g})")
        check(err <= bar, f"plain path grad {name}: {err} > {bar}")
    print(f"plain path: equal ids and masks, image max abs diff "
          f"{img_err:.3g}, loss {float(p_loss):.6g} vs {float(loss):.6g}")
    clock.done("11 (plain grad step)")

    # 12. Five Adam steps from a perturbed texture toward the true one.
    target = shadowed()
    rng = np.random.default_rng(5)
    noise = torch.from_numpy(rng.normal(
        0.0, 0.5, tuple(data.textures.shape)).astype(np.float32)).to(dev)
    params = [data.positions.detach().clone().requires_grad_(),
              (data.textures + noise).clamp(0.0, 1.0).requires_grad_()]
    opt = torch.optim.Adam(params, lr=1e-2)

    def fit_loss():
        return render_grad.l2_image_loss(
            data._replace(positions=params[0], textures=params[1]), accel,
            rays, eye, orient, target, config, frame_hw=hw,
            with_shadows=True)

    losses = []
    for _ in range(ADAM_STEPS):
        opt.zero_grad()
        loss = fit_loss()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        losses.append(float(fit_loss()))  # after the last step
    print(f"adam losses (before each step, then after the last): {losses}")
    check(all(np.isfinite(losses)), "adam: loss not finite")
    check(losses[-1] < losses[0], "adam: the loss did not fall")
    clock.done("12 (adam)")

    # 13. Timing.
    print(f"timing on {card}")
    with torch.no_grad():
        state = init_progressive(n, device=dev)
        prog_ms = time_cuda(lambda: prog(state), 5)
        with plain:
            prog_plain_ms = time_cuda(lambda: prog(state), 2)
    grad_ms = time_cuda(grad_step, 5)
    with plain:
        grad_plain_ms = time_cuda(grad_step, 2)
    times = {
        "C": (time_cuda(lambda: sweep._primary_cuda(*c_args), 20),
              time_cuda(lambda: sweep._primary_plain(*c_args), 3)),
        "H": (time_cuda(lambda: sweep._occlusion_rows_cuda(*h_args), 20),
              time_cuda(lambda: sweep._occlusion_rows_plain(*h_args), 3)),
    }
    g_times = [(time_cuda(lambda a=a: scatter._scatter_add_cuda(*a), 20),
                time_cuda(lambda a=a: scatter._scatter_add_plain(*a), 20))
               for a in g_calls]
    for a, (ms, pms) in zip(g_calls, g_times):
        print(f"kernel G, g {tuple(a[0].shape)} -> {a[2]} rows: {ms:.4f} ms "
              f"(plain {pms:.4f} ms)")
    # G's record: the mean of the backward's launches.
    times["G"] = tuple(sum(x) / len(g_times) for x in zip(*g_times))
    print(f"progressive step ({size}x{size}, shadows): kernel path "
          f"{prog_ms:.4f} ms, plain path {prog_plain_ms:.4f} ms")
    print(f"grad step ({size}x{size}): kernel path {grad_ms:.4f} ms, plain "
          f"path {grad_plain_ms:.4f} ms")
    for name, (ms, pms) in times.items():
        print(f"kernel {name}: {ms:.4f} ms per launch (plain {pms:.4f} ms)")
    clock.done("13 (timing)")

    src = "raytracercuda_torch/csrc/sweep.cu"
    return [
        {"name": "primary", "route": "cuda", "source": src,
         "replaces": "raytracercuda_tpu/trace/pallas_sweep.py:118",
         "launches": prog_launches["primary"] + grad_launches["primary"],
         "max_abs_err": c_err, "ms": times["C"][0],
         "plain_ms": times["C"][1]},
        {"name": "occlusion_rows", "route": "cuda", "source": src,
         "replaces": "raytracercuda_tpu/trace/pallas_sweep.py:201",
         "launches": prog_launches["occlusion_rows"]
         + grad_launches["occlusion_rows"],
         "max_abs_err": h_err, "ms": times["H"][0],
         "plain_ms": times["H"][1]},
        {"name": "scatter_add", "route": "cuda",
         "source": "raytracercuda_torch/csrc/scatter.cu",
         "replaces": "raytracercuda_tpu/diff/scatter.py:52",
         "launches": grad_launches["scatter_add"], "max_abs_err": g_err,
         "ms": times["G"][0], "plain_ms": times["G"][1]},
    ]


def main() -> None:
    import torch

    clock = PhaseClock()
    # 1. Device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "raytracercuda_torch")):
        fail("raytracercuda_torch/ not found beside chip_smoke.py: run it "
             "from a checkout of the repository")
    sys.path.insert(0, REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    import numpy as np

    from raytracercuda_torch.config import AccelKind, RenderConfig
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
    from raytracercuda_torch.models.scene import Material, Scene
    from raytracercuda_torch.ops import cuda_build
    from raytracercuda_torch.trace import sweep
    from raytracercuda_torch.trace.frame import FrameRenderer

    clock.done("1 (device)")

    # 2. Build.
    path, secs = cuda_build.build(verbose=True)
    print(f"build: {secs:.2f} s -> {os.path.relpath(path, REPO)}")
    cuda_build.load_library()

    # The bench frame's scene and camera (bench.py's framing).
    config = RenderConfig(accel=AccelKind.CLUSTER)
    scene = Scene(config, device=dev)
    scene.add_mesh(bumpy_sphere_mesh(NUM_FACES))
    scene.materials = [Material(albedo=(0.9, 0.7, 0.5), texture_id=0)]
    scene.textures = [np.random.default_rng(0).random((64, 64, 3))]
    data = scene.data()
    lo = data.positions.amin(dim=0)
    hi = data.positions.amax(dim=0)
    extent = float((hi - lo).amax())
    eye = ((lo + hi) / 2 - torch.tensor([0.0, 0.0, 2.0 * extent],
                                        device=dev)).to(torch.float32)
    orient = torch.eye(3, device=dev)
    rays = camera_ray_grid(SIZE, SIZE, device=dev)
    renderer = FrameRenderer(data, scene.accel, config, SIZE, SIZE)
    torch.cuda.synchronize()

    clock.done("2 (build)")

    # 3. The main path, once, through both kernels; record their inputs.
    rec = Recorder(sweep, ["_primary_shade_cuda", "_occlusion_cuda"])
    try:
        sweep.reset_launch_counts()
        frame = renderer.render(eye, orient, rays)
        torch.cuda.synchronize()
        launches = dict(sweep.launch_counts)
    finally:
        rec.restore()
    print(f"main path launches: {launches}")
    check(launches["primary_shade"] > 0, "kernel A never launched")
    check(launches["occlusion"] > 0, "kernel B never launched")
    check(tuple(frame.shape) == (SIZE * SIZE,), f"frame shape {frame.shape}")
    a_args = rec.calls["_primary_shade_cuda"][-1]
    b_args = rec.calls["_occlusion_cuda"][-1]
    lists = a_args[0]
    print(f"tiles {lists.counts.numel()}, clusters {data.num_faces} faces "
          f"-> {scene.accel.num_clusters}, listed per tile: max "
          f"{int(lists.counts.max())}, mean {float(lists.counts.float().mean()):.2f}")

    clock.done("3 (bench frame)")

    # 4. Kernels against their plain versions on the frame's inputs.
    ka = sweep._primary_shade_cuda(*a_args)
    pa = sweep._primary_shade_plain(*a_args)
    torch.cuda.synchronize()
    check(torch.equal(ka[1], pa[1]), "kernel A: slots differ from plain: "
          f"{int((ka[1] != pa[1]).sum())} pixels")
    hit = pa[0] < float(np.float32(3.4028234663852886e38))
    a_err = max(rel_err_on_hits(ka[k], pa[k], hit, f"kernel A plane {k}")
                for k in (0, 2, 3))  # t, u, v
    for k, (x, y) in enumerate(zip(ka, pa)):
        if k > 3:
            d = float((x - y).abs().max())
            check(d <= 1e-5, f"kernel A plane {k}: max abs err {d}")
            a_err = max(a_err, d)
    kb = sweep._occlusion_cuda(*b_args)
    pb = sweep._occlusion_plain(*b_args)
    torch.cuda.synchronize()
    check(torch.equal(kb, pb), "kernel B: masks differ from plain: "
          f"{int((kb != pb).sum())} rays")
    b_err = float((kb.int() - pb.int()).abs().max())
    hits, shadowed = int(hit.sum()), int(pb.sum())
    print(f"kernel A matches plain: {hits} hit rays, max abs err {a_err:.3g}")
    print(f"kernel B matches plain: {shadowed} shadowed of "
          f"{int(b_args[3].sum())} active shadow rays")
    check(hits > 0, "no primary ray hit the scene")
    check(shadowed > 0, "no pixel is in shadow")

    clock.done("4 (A, B vs plain)")

    # 5. The frame with the plain versions on the card.
    with PlainOnCard({sweep: {
            "_primary_shade_cuda": sweep._primary_shade_plain,
            "_occlusion_cuda": sweep._occlusion_plain}}):
        plain_frame = renderer.render(eye, orient, rays)
        torch.cuda.synchronize()
        plain_ms = time_cuda(lambda: renderer.render(eye, orient, rays),
                             FRAMES)
    chan = [((frame >> s) & 0xFF) - ((plain_frame >> s) & 0xFF)
            for s in (16, 8, 0)]
    worst = max(int(c.abs().max()) for c in chan)
    check(worst <= 1, f"kernel frame vs plain frame: u8 diff {worst}")
    background = (0 << 16) | (255 << 8) | 0
    n_hit_px = int((frame != background).sum())
    print(f"frame matches plain frame (max u8 diff {worst}); "
          f"{n_hit_px} of {SIZE * SIZE} pixels not background")
    check(n_hit_px > 0, "frame is all background")

    clock.done("5 (plain frame)")

    # 6. Timing.
    frame_ms = time_cuda(lambda: renderer.render(eye, orient, rays), FRAMES)
    a_ms = time_cuda(lambda: sweep._primary_shade_cuda(*a_args), 20)
    a_plain_ms = time_cuda(lambda: sweep._primary_shade_plain(*a_args), 5)
    b_ms = time_cuda(lambda: sweep._occlusion_cuda(*b_args), 20)
    b_plain_ms = time_cuda(lambda: sweep._occlusion_plain(*b_args), 5)
    px = SIZE * SIZE
    cast = px + int(b_args[3].sum())  # primary rays + cast shadow rays
    for name, ms in (("kernel", frame_ms), ("plain", plain_ms)):
        print(f"frame ({name} path): {ms:.4f} ms/frame, "
              f"{px / ms * 1e3:.6g} rays/s as bench.py counts them (W*H "
              f"per frame), {cast / ms * 1e3:.6g} primary+shadow rays/s "
              f"cast")
    print(f"kernel A: {a_ms:.4f} ms (plain {a_plain_ms:.4f} ms); "
          f"kernel B: {b_ms:.4f} ms (plain {b_plain_ms:.4f} ms)")

    clock.done("6 (frame timing)")

    c4_kernels = diff_path(dev, clock, card)

    src = "raytracercuda_torch/csrc/sweep.cu"
    print(json.dumps({"kernels": [
        {"name": "primary_shade", "route": "cuda", "source": src,
         "replaces": "raytracercuda_tpu/trace/pallas_sweep.py:598",
         "launches": launches["primary_shade"], "max_abs_err": a_err,
         "ms": a_ms, "plain_ms": a_plain_ms},
        {"name": "occlusion", "route": "cuda", "source": src,
         "replaces": "raytracercuda_tpu/trace/pallas_sweep.py:870",
         "launches": launches["occlusion"], "max_abs_err": b_err,
         "ms": b_ms, "plain_ms": b_plain_ms},
        *c4_kernels,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    main()
