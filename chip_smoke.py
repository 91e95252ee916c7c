#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`raytracercuda_torch`) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

  1. requires a CUDA device and prints its name and power limit;
  2. builds the CUDA kernels from `raytracercuda_torch/csrc/` and prints
     the build time;
  3. renders the bench frame once through `FrameRenderer` (512x512, a
     69,451-triangle bumpy sphere with uvs and a texture, shadows on) and
     requires that kernels A and B both launched in that run;
  4. holds kernel A and kernel B against their plain PyTorch versions on
     the card, on the inputs that frame gave them (A: slots equal, t/u/v
     within 1e-6 relative on hits, attributes within 1e-5; B: equal masks);
  5. renders the same frame with the plain versions on the card and
     requires every u8 channel within 1, hit pixels and shadowed pixels;
  6. times 50 frames on each path and each kernel beside its plain
     version.

Any failure exits non-zero.  The last two lines of standard output are a
JSON object of the kernels' counts, errors and times, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SIZE = 512
NUM_FACES = 69451  # bunny.obj's triangle count (BASELINE.json)
FRAMES = 50
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


def main() -> None:
    import torch

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
    print(smi.stdout.strip().splitlines()[0])
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

    # 3. The main path, once, through both kernels; record their inputs.
    real = {"A": sweep._primary_shade_cuda, "B": sweep._occlusion_cuda}
    seen = {}

    def recorder(name):
        def run(*args):
            seen[name] = args
            return real[name](*args)
        return run

    sweep._primary_shade_cuda = recorder("A")
    sweep._occlusion_cuda = recorder("B")
    try:
        sweep.reset_launch_counts()
        frame = renderer.render(eye, orient, rays)
        torch.cuda.synchronize()
        launches = dict(sweep.launch_counts)
    finally:
        sweep._primary_shade_cuda = real["A"]
        sweep._occlusion_cuda = real["B"]
    print(f"main path launches: {launches}")
    check(launches["primary_shade"] > 0, "kernel A never launched")
    check(launches["occlusion"] > 0, "kernel B never launched")
    check(tuple(frame.shape) == (SIZE * SIZE,), f"frame shape {frame.shape}")
    lists = seen["A"][0]
    print(f"tiles {lists.counts.numel()}, clusters {data.num_faces} faces "
          f"-> {scene.accel.num_clusters}, listed per tile: max "
          f"{int(lists.counts.max())}, mean {float(lists.counts.float().mean()):.2f}")

    # 4. Kernels against their plain versions on the frame's inputs.
    a_args, b_args = seen["A"], seen["B"]
    ka = sweep._primary_shade_cuda(*a_args)
    pa = sweep._primary_shade_plain(*a_args)
    torch.cuda.synchronize()
    check(torch.equal(ka[1], pa[1]), "kernel A: slots differ from plain: "
          f"{int((ka[1] != pa[1]).sum())} pixels")
    hit = pa[0] < float(np.float32(3.4028234663852886e38))
    a_err = 0.0
    for k, (x, y) in enumerate(zip(ka, pa)):
        if k == 1:
            continue
        if k <= 3:  # t, u, v: relative on hits
            d = (x[hit] - y[hit]).abs()
            check(bool((d <= 1e-6 * y[hit].abs()).all()),
                  f"kernel A plane {k}: beyond 1e-6 relative")
            a_err = max(a_err, float(d.max()) if d.numel() else 0.0)
        else:
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

    # 5. The frame with the plain versions on the card.
    sweep._primary_shade_cuda = sweep._primary_shade_plain
    sweep._occlusion_cuda = sweep._occlusion_plain
    try:
        plain_frame = renderer.render(eye, orient, rays)
        torch.cuda.synchronize()
        plain_ms = time_cuda(lambda: renderer.render(eye, orient, rays),
                             FRAMES)
    finally:
        sweep._primary_shade_cuda = real["A"]
        sweep._occlusion_cuda = real["B"]
    chan = [((frame >> s) & 0xFF) - ((plain_frame >> s) & 0xFF)
            for s in (16, 8, 0)]
    worst = max(int(c.abs().max()) for c in chan)
    check(worst <= 1, f"kernel frame vs plain frame: u8 diff {worst}")
    background = (0 << 16) | (255 << 8) | 0
    n_hit_px = int((frame != background).sum())
    print(f"frame matches plain frame (max u8 diff {worst}); "
          f"{n_hit_px} of {SIZE * SIZE} pixels not background")
    check(n_hit_px > 0, "frame is all background")

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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
