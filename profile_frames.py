#!/usr/bin/env python3
"""Profile the PyTorch port's config-2 and config-5 frames on one NVIDIA GPU.

Run from the root of a checkout: ``python3 profile_frames.py [--out DIR]
[--frames N]``.  It builds the kernels and makes the scenes as
`chip_smoke.py` does: config 2, the public-API frame at 256x256 on BRUTE
(a `Camera.clear` and a `Camera.trace_scene` per frame); config 5, the
1920x1080 frame with two mirror bounces and shadows; and config 5 with no
bounce.  For each frame it prints

  * host ms per frame: the wall clock over N frames after a warm-up,
    with a sync before and after, without the profiler, and over N more
    frames under it;
  * device ms per frame: the sum of the device activities (kernels,
    copies, fills) that `torch.profiler` records over those N frames;
  * the idle share, 1 - device / host, both over the traced frames;
  * device activities per frame (kernel launches, copies and fills).

The 60 rows of each profile with the most device time go to
``DIR/profile_<frame>.txt`` (DIR defaults to ``chiprun_out``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def profile(name, fn, frames, out_dir):
    """Time ``fn`` on the host, then profile it; print one line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / frames

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / frames
    avgs = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    device = [e for e in avgs if e.device_type == DeviceType.CUDA]
    device_ms = sum(getattr(e, key) for e in device) / 1e3 / frames
    count = sum(e.count for e in device) / frames
    path = os.path.join(out_dir, f"profile_{name}.txt")
    with open(path, "w") as f:
        f.write(avgs.table(sort_by=key, row_limit=60))
    if device_ms == 0.0:
        print(f"{name}: host {host_ms:.4f} ms/frame; the profiler traced no "
              f"device activity (device time not measured) -> {path}")
        return
    print(f"{name}: host {host_ms:.4f} ms/frame ({traced_ms:.4f} while "
          f"traced), device {device_ms:.4f} ms/frame, idle "
          f"{1.0 - device_ms / traced_ms:.4f}, {count:.1f} device "
          f"activities/frame -> {path}")
    top = sorted(device, key=lambda e: -getattr(e, key))[:4]
    for e in top:
        print(f"  {getattr(e, key) / 1e3 / frames:10.4f} ms/frame, "
              f"{e.count / frames:6.1f}/frame  {e.key[:70]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    parser.add_argument("--frames", type=int, default=5)
    args = parser.parse_args()

    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: profiling needs a GPU")
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed")

    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.ops import cuda_build
    from raytracercuda_torch.trace.bounce import render_bounces
    from raytracercuda_torch.trace.pipeline import rotate_rays

    dev = torch.device("cuda", 0)
    cuda_build.build()
    cuda_build.load_library()

    scene, cam, target, eye, orient = cs.config2_scene(dev, cs.C2_SIZE,
                                                       cs.C2_SUZANNE)

    def config2():
        cam.clear(target, cs.CLEAR_VALUE)
        return cam.trace_scene(eye, orient, scene, target)

    with torch.no_grad():
        profile("config2", config2, args.frames, args.out)

        config, data, accel, eye5 = cs.config5_scene(dev, cs.C5_MESHES)
        w, h = cs.C5_WIDTH, cs.C5_HEIGHT
        dirs = rotate_rays(camera_ray_grid(w, h, device=dev),
                           torch.eye(3, device=dev))
        for name, nb in (("config5", 2), ("config5_nobounce", 0)):
            profile(name, lambda nb=nb: render_bounces(
                accel, data, eye5, dirs, h, w, config, num_bounces=nb),
                args.frames, args.out)


if __name__ == "__main__":
    main()
