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
     beside their plain versions;
 14. builds config 2's scene through the public API on BRUTE (a
     15,488-triangle bumpy sphere standing in for suzanne.obj, and the
     reference's quad) with a 256x256 `Camera` and `RenderTarget`;
 15. clears the target through `Camera.clear` (kernel D, held exactly
     against `torch.full`) and traces it through `Camera.trace_scene`
     (kernel E), requiring both kernels launched and status 0;
 16. holds E against its plain version on the frame's rays (equal faces,
     t/u/v bit-equal) and D against its plain version, renders the frame
     with the plain versions (equal packed frames), prints the hit share
     and the status codes of the API's misuse cases, and times the frame,
     E and D beside their plain versions;
 17. builds config 5's scene (three bumpy spheres of 69,451, 345,944 and
     100,002 triangles, reflectivity 0.3) and renders its 1920x1080 frame
     with two mirror bounces and shadows through `render_bounces`,
     requiring kernels A and B and two launches of kernel F;
 18. prints the active rays and cluster-list lengths of the primary
     pass, the shadows and each bounce, and the share of pixels the
     bounces change;
 19. holds A (with reflectivity) and B against their plain versions on
     that frame's inputs, and F on the first bounce's (A and F: slots
     equal, t/u/v within 1e-6 relative on hits, attributes within 1e-5;
     B: equal masks);
 20. at 256x144, holds the cluster-route frame against the brute-force
     route's (kernel E): at least 99% of pixels within 1e-4;
 21. times the frame, A, B and F per launch and one `sort_bounces=True`
     frame.

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
# Config 2 (scripts/bench_configs.py:79-102): 256x256, BRUTE, suzanne.obj's
# 15,488 triangles (BASELINE.md:21) and the reference's quad.
C2_SIZE = 256
C2_SUZANNE = 15488
CLEAR_VALUE = 0xFF00FF00
# Config 5 (scripts/bench_configs.py:164-200): 1920x1080, two bounces.
# The bunny stand-in sits on bunny.obj's bounding box: centre
# (-0.0168, 0.1101, -0.0016), half its largest extent as radius.
C5_WIDTH, C5_HEIGHT = 1920, 1080
C5_MESHES = (  # (faces, radius, centre, seed)
    (69451, 0.078, (-0.0168, 0.1101, -0.0016), 0),
    (345944, 0.9, (1.6, 0.8, 0.2), 2),
    (100002, 0.7, (-1.5, 0.6, -0.3), 3),
)
C5_SMALL = (256, 144)  # the frame held against the brute-force route
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


def time_once(fn):
    """``(fn(), milliseconds)`` of one call on the card, no warm-up: for
    plain versions too slow to run twice."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def rel_err_on_hits(x, y, hit, name: str) -> float:
    """Require ``x`` within 1e-6 relative of ``y`` where ``hit``; returns
    the largest absolute difference there."""
    d = (x[hit] - y[hit]).abs()
    check(bool((d <= 1e-6 * y[hit].abs()).all()),
          f"{name}: beyond 1e-6 relative")
    return float(d.max()) if d.numel() else 0.0


def shade_err(k, p, name: str) -> tuple[float, int]:
    """Hold a shading kernel's planes ``k`` (t, slot, u, v, attributes)
    against its plain version's ``p``: slots equal, t/u/v within 1e-6
    relative on hits, attributes within 1e-5.  Returns the largest
    absolute error and the number of hit rays."""
    import torch

    check(torch.equal(k[1], p[1]), f"{name}: slots differ from plain: "
          f"{int((k[1] != p[1]).sum())} rays")
    hit = p[0] < float(3.4028234663852886e38)
    err = max(rel_err_on_hits(k[i], p[i], hit, f"{name} plane {i}")
              for i in (0, 2, 3))  # t, u, v
    for i in range(4, len(p)):
        d = float((k[i] - p[i]).abs().max())
        check(d <= 1e-5, f"{name} plane {i}: max abs err {d}")
        err = max(err, d)
    return err, int(hit.sum())


def occlusion_err(k, p, name: str) -> float:
    """Require an any-hit kernel's mask ``k`` equal to its plain version's
    ``p``; returns the largest difference (0)."""
    import torch

    check(torch.equal(k, p), f"{name}: masks differ from plain: "
          f"{int((k != p).sum())} rays")
    return float((k.int() - p.int()).abs().max())


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
    h_err = occlusion_err(kh, ph, "kernel H")
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


def config2_scene(dev, size, suzanne_faces):
    """Config 2's scene through the public API (scripts/bench_configs.py:
    79-102): BRUTE, the suzanne stand-in ``bumpy_sphere_mesh`` at the
    origin (radius 1) and the reference's quad at z = 2.5, a ``size``
    square `Camera` and locked `RenderTarget`, eye (0, 0, -2.1).
    Returns ``(scene, camera, target, eye, orient)``."""
    import numpy as np

    import raytracercuda_torch as rt
    from raytracercuda_torch.models.procedural import (bumpy_sphere_mesh,
                                                       quad_mesh)

    scene = rt.Scene.create(rt.RenderConfig(accel=rt.AccelKind.BRUTE),
                            device=dev)
    scene.add_mesh(bumpy_sphere_mesh(suzanne_faces, radius=1.0,
                                     center=(0.0, 0.0, 0.0)))
    scene.add_mesh(quad_mesh(z=2.5))
    cam = rt.Camera.create(dev)
    check(cam.set_initial_rays(size, size, -1, 1, -1, 1, 1) == 0,
          "set_initial_rays failed")
    target = rt.RenderTarget.create(size, size, dev)
    check(target.lock() == 0, "lock failed")
    eye = np.array([0.0, 0.0, -2.1], np.float32)
    return scene, cam, target, eye, rt.orient_from_pan_pitch(0.0, 0.0)


def api_path(dev, clock, card, size=C2_SIZE, suzanne_faces=C2_SUZANNE):
    """Phases 14-16: config 2's frame through the public API, kernels D
    and E.  Returns their JSON records."""
    import torch

    import raytracercuda_torch as rt
    from raytracercuda_torch.ops import clear
    from raytracercuda_torch.trace import bruteforce

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # 14. The scene, camera and target, as bench_configs.config2 makes them.
    scene, cam, target, eye, orient = config2_scene(dev, size, suzanne_faces)
    print(f"config 2: {scene.data().num_faces} faces, BRUTE, {size}x{size}")
    check(cam.trace_scene(eye, orient, scene, target) == 0, "warm-up frame")
    sync()
    clock.done("14 (config 2 scene)")

    # 15. The main path: clear (D), then trace (E).
    n = size * size
    rec = Recorder(bruteforce, ["_brute_cuda"])
    try:
        clear.reset_launch_counts()
        bruteforce.reset_launch_counts()
        err_clear = cam.clear(target, CLEAR_VALUE)
        cleared = target.buffer.clone()
        err = cam.trace_scene(eye, orient, scene, target)
        sync()
        launches = {**clear.launch_counts, **bruteforce.launch_counts}
    finally:
        rec.restore()
    print(f"config 2 launches: {launches}")
    check(err_clear == 0 and err == 0, f"clear {err_clear}, trace {err}")
    check(launches["clear"] > 0, "kernel D never launched")
    check(launches["brute"] > 0, "kernel E never launched")
    full = torch.full((n,), CLEAR_VALUE, dtype=torch.int64, device=dev)
    check(torch.equal(cleared, full), "kernel D: buffer differs from "
          "torch.full")
    frame = target.buffer.clone()
    miss = 255 << 8
    hit_share = float((frame != miss).float().mean())
    print(f"config 2 frame: hit share {hit_share:.4f}")
    check(0.0 < hit_share < 1.0, f"hit share {hit_share}")
    clock.done("15 (config 2 frame)")

    # 16. E and D against their plain versions; the plain-path frame; the
    # misuse cases' codes; timing.
    e_args = rec.calls["_brute_cuda"][-1]
    ke = bruteforce._brute_cuda(*e_args)
    pe = bruteforce._brute_plain(*e_args)
    sync()
    check(torch.equal(ke[3], pe[3]), "kernel E: faces differ from plain: "
          f"{int((ke[3] != pe[3]).sum())} rays")
    for k, name in enumerate("tuv"):
        check(torch.equal(ke[k], pe[k]), f"kernel E: {name} not bit-equal")
    e_err = 0.0  # bit-equal, checked above
    print(f"kernel E matches plain bit for bit: {int((pe[3] >= 0).sum())} "
          f"hit rays of {pe[3].numel()}")
    kd = clear._clear_cuda(n, CLEAR_VALUE, dev)
    pd = clear._clear_plain(n, CLEAR_VALUE, dev)
    check(torch.equal(kd, pd), "kernel D differs from its plain version")
    plain = PlainOnCard({bruteforce: {"_brute_cuda": bruteforce._brute_plain},
                         clear: {"_clear_cuda": clear._clear_plain}})
    plain_target = rt.RenderTarget.create(size, size, dev)
    with plain:
        check(cam.clear(plain_target, CLEAR_VALUE) == 0, "plain clear")
        check(cam.trace_scene(eye, orient, scene, plain_target) == 0,
              "plain frame")
        sync()
        plain_frame_ms = time_cuda(
            lambda: cam.trace_scene(eye, orient, scene, plain_target), 3)
    check(torch.equal(plain_target.buffer, frame),
          "config 2: the plain-path frame differs")
    print("config 2 frame equals the plain-path frame")
    codes = {
        "no_render_target": cam.trace_scene(eye, orient, scene, None),
        "size_mismatch": cam.trace_scene(
            eye, orient, scene, rt.RenderTarget.create(2 * size, size, dev)),
        "camera_without_rays": rt.Camera.create(dev).trace_scene(
            eye, orient, scene, target),
        "no_scene": cam.trace_scene(eye, orient, None, target),
        "clear_without_target": cam.clear(None, 0),
        "zero_width": rt.Camera.create(dev).set_initial_rays(0, size),
        "lock_twice": target.lock(),
        "unlock": target.unlock(),
        "unlock_twice": target.unlock(),
    }
    print(f"config 2 misuse codes: {codes}")
    want = {"no_render_target": 8, "size_mismatch": 5,
            "camera_without_rays": 2, "no_scene": 2,
            "clear_without_target": 8, "zero_width": 2, "lock_twice": 6,
            "unlock": 0, "unlock_twice": 7}
    check(codes == want, f"misuse codes {codes}, want {want}")

    print(f"timing on {card}")
    frame_ms = time_cuda(lambda: cam.trace_scene(eye, orient, scene, target),
                         20)
    e_ms = time_cuda(lambda: bruteforce._brute_cuda(*e_args), 20)
    e_plain_ms = time_cuda(lambda: bruteforce._brute_plain(*e_args), 3)
    d_ms = time_cuda(lambda: clear._clear_cuda(n, CLEAR_VALUE, dev), 100)
    d_plain_ms = time_cuda(lambda: clear._clear_plain(n, CLEAR_VALUE, dev),
                           100)
    print(f"config 2 frame ({size}x{size}, BRUTE): kernel path "
          f"{frame_ms:.4f} ms, plain path {plain_frame_ms:.4f} ms, "
          f"{n / frame_ms * 1e3:.6g} rays/s")
    print(f"kernel E: {e_ms:.4f} ms per launch (plain {e_plain_ms:.4f} ms); "
          f"kernel D: {d_ms:.4f} ms (plain {d_plain_ms:.4f} ms)")
    clock.done("16 (config 2 checks, timing)")
    return [
        {"name": "clear", "route": "cuda",
         "source": "raytracercuda_torch/csrc/frame.cu",
         "replaces": "raytracercuda_tpu/ops/clear.py:21",
         "launches": launches["clear"], "max_abs_err": 0.0, "ms": d_ms,
         "plain_ms": d_plain_ms},
        {"name": "brute", "route": "cuda",
         "source": "raytracercuda_torch/csrc/brute.cu",
         "replaces": "raytracercuda_tpu/trace/pallas_brute.py:36",
         "launches": launches["brute"], "max_abs_err": e_err, "ms": e_ms,
         "plain_ms": e_plain_ms},
    ]


def config5_scene(dev, meshes):
    """Config 5's scene (scripts/bench_configs.py:164-184): the three
    meshes of ``meshes``, reflectivity ``linspace(0.3, 0.6)`` over the
    materials (0.3 for the single default one), clusters built once, the
    eye from ``frame_eye(dist=1.2)``, orient the identity."""
    import torch

    from raytracercuda_torch.config import AccelKind, RenderConfig
    from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
    from raytracercuda_torch.models.scene import Scene

    config = RenderConfig(accel=AccelKind.CLUSTER)
    scene = Scene.create(config, device=dev)
    for faces, radius, center, seed in meshes:
        scene.add_mesh(bumpy_sphere_mesh(faces, radius=radius, center=center,
                                         seed=seed))
    data = scene.data()
    nm = data.reflectivity.shape[0]
    data = data._replace(reflectivity=torch.linspace(0.3, 0.6, nm,
                                                     device=dev))
    accel = scene.accel
    lo = data.positions.amin(dim=0)
    hi = data.positions.amax(dim=0)
    extent = float((hi - lo).amax())
    eye = ((lo + hi) / 2 - torch.tensor([0.0, 0.0, 1.2 * extent],
                                        device=dev)).to(torch.float32)
    return config, data, accel, eye


def bounce_path(dev, clock, card, width=C5_WIDTH, height=C5_HEIGHT,
                meshes=C5_MESHES, small=C5_SMALL, frames=3):
    """Phases 17-21: config 5's multi-bounce frame, kernels A, B and F,
    and the brute-force route (kernel E) at a reduced size.  Returns F's
    JSON record and, for A and B, ``{name: (launches, max_abs_err)}`` of
    this path's run."""
    import torch

    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.trace import bounce_sweep, bruteforce, sweep
    from raytracercuda_torch.trace.bounce import render_bounces
    from raytracercuda_torch.trace.pipeline import pad_frame, rotate_rays

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # 17. The scene and the frame, once, through A, B and F.
    config, data, accel, eye = config5_scene(dev, meshes)
    orient = torch.eye(3, device=dev)

    def rays(w, h):
        return rotate_rays(camera_ray_grid(w, h, device=dev), orient)

    dirs = rays(width, height)

    def frame(nb=2):
        return render_bounces(accel, data, eye, dirs, height, width, config,
                              num_bounces=nb)

    print(f"config 5: {data.num_faces} faces -> {accel.num_clusters} "
          f"clusters, {width}x{height}, eye {eye.tolist()}")
    frame()  # warm-up
    sync()
    rec_ab = Recorder(sweep, ["_primary_shade_cuda", "_occlusion_cuda"])
    rec_f = Recorder(bounce_sweep, ["_general_shade_cuda"])
    try:
        sweep.reset_launch_counts()
        img = frame()
        sync()
        launches = dict(sweep.launch_counts)
    finally:
        rec_ab.restore()
        rec_f.restore()
    print(f"config 5 launches: {launches}")
    check(launches["primary_shade"] > 0, "kernel A never launched")
    check(launches["occlusion"] > 0, "kernel B never launched")
    check(launches["general_shade"] == 2,
          f"kernel F launched {launches['general_shade']} times, not 2")
    check(tuple(img.shape) == (width * height, 3)
          and bool(torch.isfinite(img).all()), "config 5 image not finite")
    clock.done("17 (config 5 frame)")

    # 18. What each pass swept, and what the bounces changed.
    a_args = rec_ab.calls["_primary_shade_cuda"][-1]
    b_args = rec_ab.calls["_occlusion_cuda"][-1]
    a_lists = a_args[0]

    def list_stats(lists):
        counts = lists.counts
        listing = counts > 0
        mean = float(counts[listing].float().mean()) if listing.any() else 0
        return (f"{int(listing.sum())} of {counts.numel()} tiles list "
                f"clusters, mean {mean:.1f} over those, max "
                f"{int(counts.max())}")

    print(f"primary pass: {list_stats(a_lists)}")
    print(f"shadows: {int(b_args[3].sum())} active rays; "
          f"{list_stats(b_args[0])}")
    for b, args in enumerate(rec_f.calls["_general_shade_cuda"]):
        act = args[3]
        print(f"bounce {b + 1}: {int(act.sum())} active rays in "
              f"{int(act.any(dim=1).sum())} tiles; {list_stats(args[0])}")
    flat = frame(0)
    changed = float(((img - flat).abs() > 1e-6).any(dim=-1).float().mean())
    print(f"bounce_changed_px_frac {changed:.6f}")
    check(changed > 0.0, "the bounces change no pixel")
    clock.done("18 (config 5 lists)")

    # 19. A (with reflectivity) and B against their plain versions on this
    # frame's inputs, F on the first bounce's.
    check(a_args[5], "config 5: kernel A ran without reflectivity")
    ka = sweep._primary_shade_cuda(*a_args)
    pa, a_plain_ms = time_once(lambda: sweep._primary_shade_plain(*a_args))
    a_err, a_hits = shade_err(ka, pa, "kernel A (config 5)")
    kb = sweep._occlusion_cuda(*b_args)
    pb, b_plain_ms = time_once(lambda: sweep._occlusion_plain(*b_args))
    b_err = occlusion_err(kb, pb, "kernel B (config 5)")
    print(f"kernel A (with reflectivity) matches plain on config 5: {a_hits} "
          f"hit rays, max abs err {a_err:.3g}; kernel B matches plain: "
          f"{int(pb.sum())} shadowed of {int(b_args[3].sum())} active rays")
    f_args = rec_f.calls["_general_shade_cuda"][0]
    kf = bounce_sweep._general_shade_cuda(*f_args)
    pf, f_plain_ms = time_once(
        lambda: bounce_sweep._general_shade_plain(*f_args))
    f_err, f_hits = shade_err(kf, pf, "kernel F")
    print(f"kernel F matches plain on bounce 1: {f_hits} hit rays, "
          f"max abs err {f_err:.3g}")
    clock.done("19 (A, B, F vs plain)")

    # 20. The cluster route against the brute-force route at a reduced
    # size (the JAX package's bar for its kernel route, test_bounce.py:192).
    sw, sh = small
    small_dirs = rays(sw, sh)
    bruteforce.reset_launch_counts()
    rgb_c = render_bounces(accel, data, eye, small_dirs, sh, sw, config)
    rgb_b = render_bounces(accel, data, eye, small_dirs, sh, sw, config,
                           use_brute=True)
    sync()
    brute_launches = bruteforce.launch_counts["brute"]
    share = float(torch.isclose(rgb_c, rgb_b, rtol=1e-4, atol=1e-4)
                  .all(dim=-1).float().mean())
    print(f"config 5 at {sw}x{sh}: cluster route vs brute route (kernel E, "
          f"{brute_launches} launches): {share:.6f} of pixels within 1e-4")
    check(brute_launches > 0, "kernel E never launched")
    check(share >= 0.99, f"cluster vs brute route: share {share} < 0.99")
    clock.done("20 (cluster vs brute route)")

    # 21. Timing: the frame, F, one frame with the bounces re-binned.
    print(f"timing on {card}")
    frame_ms = time_cuda(frame, frames)
    f_ms = time_cuda(lambda: bounce_sweep._general_shade_cuda(*f_args), 5)
    a_ms = time_cuda(lambda: sweep._primary_shade_cuda(*a_args), 20)
    b_ms = time_cuda(lambda: sweep._occlusion_cuda(*b_args), 20)
    tp = config.trace.dense_tile_px
    pdirs, hp, wp = pad_frame(dirs, height, width, tp)
    blocks, has_uv = sweep.shade_segment_blocks(accel, data)

    def tiled(sort):
        return bounce_sweep.render_bounces_tiled(
            accel, blocks, has_uv, data.textures, eye, pdirs, hp, wp,
            tile_px=tp, trace_cfg=config.trace, sort_bounces=sort)

    unsorted = tiled(False)
    sorted_img, sorted_ms = time_once(lambda: tiled(True))
    sort_diff = float((sorted_img - unsorted).abs().max())
    print(f"config 5 frame ({width}x{height}, 2 bounces, shadows): "
          f"{frame_ms:.4f} ms, {width * height / frame_ms * 1e3:.6g} rays/s "
          f"(W*H per frame); sort_bounces=True frame {sorted_ms:.4f} ms "
          f"(one frame, no warm-up), max abs diff to unsorted {sort_diff:.3g}")
    check(sort_diff <= 1e-6, f"sorted bounces differ by {sort_diff}")
    print(f"kernel F (bounce 1): {f_ms:.4f} ms per launch (plain "
          f"{f_plain_ms:.4f} ms, one run); on config 5, kernel A "
          f"{a_ms:.4f} ms (plain {a_plain_ms:.4f} ms, one run), kernel B "
          f"{b_ms:.4f} ms (plain {b_plain_ms:.4f} ms, one run)")
    clock.done("21 (config 5 timing)")
    f_record = {"name": "general_shade", "route": "cuda",
                "source": "raytracercuda_torch/csrc/sweep.cu",
                "replaces": "raytracercuda_tpu/trace/pallas_bounce.py:108",
                "launches": launches["general_shade"], "max_abs_err": f_err,
                "ms": f_ms, "plain_ms": f_plain_ms}
    return [f_record], {"primary_shade": (launches["primary_shade"], a_err),
                        "occlusion": (launches["occlusion"], b_err)}


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
    a_err, hits = shade_err(ka, pa, "kernel A")
    kb = sweep._occlusion_cuda(*b_args)
    pb = sweep._occlusion_plain(*b_args)
    torch.cuda.synchronize()
    b_err = occlusion_err(kb, pb, "kernel B")
    shadowed = int(pb.sum())
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
    c2_kernels = api_path(dev, clock, card)
    c5_kernels, c5_ab = bounce_path(dev, clock, card)

    # A and B: launches of both paths that run them, the larger error;
    # times at the bench frame's shapes (config 5's are printed above).
    src = "raytracercuda_torch/csrc/sweep.cu"
    print(json.dumps({"kernels": [
        {"name": "primary_shade", "route": "cuda", "source": src,
         "replaces": "raytracercuda_tpu/trace/pallas_sweep.py:598",
         "launches": launches["primary_shade"] + c5_ab["primary_shade"][0],
         "max_abs_err": max(a_err, c5_ab["primary_shade"][1]),
         "ms": a_ms, "plain_ms": a_plain_ms},
        {"name": "occlusion", "route": "cuda", "source": src,
         "replaces": "raytracercuda_tpu/trace/pallas_sweep.py:870",
         "launches": launches["occlusion"] + c5_ab["occlusion"][0],
         "max_abs_err": max(b_err, c5_ab["occlusion"][1]),
         "ms": b_ms, "plain_ms": b_plain_ms},
        *c4_kernels, *c2_kernels, *c5_kernels,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    main()
