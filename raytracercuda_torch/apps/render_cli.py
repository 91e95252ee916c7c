"""Viewer-less render CLI — the TestProgram replacement (counterpart of
`raytracercuda_tpu/apps/render_cli.py`).

The reference's app (`TestProgram/Program.cpp`) opens an SDL window, flies
a WASD camera and blits frames through CUDA-GL interop.  This CLI renders
N frames of an orbit path to PNG files instead, with the same per-phase
profiler output (Scene/Trace/Present) the reference prints once per
second.  It runs on the card unless ``--device cpu`` is given.

    python -m raytracercuda_torch.apps.render_cli suzanne.obj -o out/ \\
        --size 512 --frames 8 --accel cluster --shading lambert

Routes, by ``--shading`` and ``--accel``:

  * ``parity``: `Camera.trace_scene`, the reference's packed normal
    shading; BRUTE traces through kernel E, CLUSTER through kernel C
    (edge-padded where the 16-pixel tile does not divide the size), BVH
    through kernel L's tile beams (kernel K's per-ray walk where the
    16-pixel beam tile does not divide the size), WAVEFRONT through its
    plain PyTorch rounds;
  * ``lambert``/``lambert-shadow`` on CLUSTER at a size the tile divides:
    `FrameRenderer` (kernels A and B), the bench's frame;
  * otherwise `render_rgb` and `pack_shaded` (shadows through kernel K's
    any-hit walk on BVH and WAVEFRONT).

With ``--accel grid`` every route traces through kernel M's march;
``lambert-shadow`` raises `NotImplementedError` there, as the JAX
package's route fails on a grid (`render_rgb` has no GRID shadows).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", help="OBJ path or a Content mesh name (suzanne.obj, f16.obj, bunny.obj)")
    p.add_argument("-o", "--out", default="out", help="output directory for PNG frames")
    p.add_argument("--size", type=int, default=512, help="square frame size (reference window: 500)")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--accel",
                   choices=["cluster", "bvh", "grid", "wavefront", "brute"],
                   default="cluster")
    p.add_argument("--shading", choices=["parity", "lambert", "lambert-shadow"], default="parity")
    p.add_argument("--eye", type=float, nargs=3, default=None,
                   help="camera position (default: auto-framed like Model.cpp stats)")
    p.add_argument("--pan", type=float, default=0.0)
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--orbit", type=float, default=0.0,
                   help="degrees of yaw orbit per frame (animates the fly camera)")
    p.add_argument("--zoom", type=float, default=1.0)
    p.add_argument("--profile", action="store_true", help="print per-phase timings")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from raytracercuda_torch import (
        AccelKind, Camera, RenderConfig, RenderTarget, Scene,
    )
    from raytracercuda_torch.device import resolve_device
    from raytracercuda_torch.models.camera import orient_from_pan_pitch
    from raytracercuda_torch.models.loader import load_model
    from raytracercuda_torch.utils import content
    from raytracercuda_torch.utils.png import write_packed_png
    from raytracercuda_torch.utils.profiler import Profiler

    model_path = args.model if os.path.exists(args.model) else content.find(args.model)
    if not model_path:
        print(f"model not found: {args.model}", file=sys.stderr)
        return 1

    dev = resolve_device(args.device)
    config = RenderConfig(accel=AccelKind(args.accel))
    prof = Profiler()

    scene = Scene.create(config, device=dev)
    with prof.phase("Scene"):
        if not load_model(model_path, scene):
            print(f"failed to load {model_path}", file=sys.stderr)
            return 1
        data = scene.data()
        scene.update_gpu_scene()  # build the acceleration structure
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Auto-frame: back the eye off the AABB like the bench does.
    lo = data.positions.amin(dim=0).cpu().numpy()
    hi = data.positions.amax(dim=0).cpu().numpy()
    center, extent = (lo + hi) / 2, float(np.max(hi - lo))
    eye = np.asarray(args.eye, np.float32) if args.eye else (
        center - np.array([0, 0, 2.0 * extent])
    ).astype(np.float32)

    cam = Camera.create(dev)
    err = cam.set_initial_rays(args.size, args.size, -1, 1, -1, 1, args.zoom)
    if err != 0:
        raise RuntimeError(f"camera error {err}")
    rt = RenderTarget.create(args.size, args.size, dev)
    if rt.lock() != 0:
        raise RuntimeError("render target already locked")

    os.makedirs(args.out, exist_ok=True)
    shading = args.shading

    # Product fast path: cluster accel + lambert shading renders through
    # FrameRenderer — the same frame bench.py measures (kernels A and B).
    renderer = None
    if (args.accel == "cluster" and shading != "parity"
            and args.size % config.trace.dense_tile_px == 0):
        from raytracercuda_torch.trace.frame import FrameRenderer

        renderer = FrameRenderer(
            data, scene.accel, config, args.size, args.size,
            shadows=(shading == "lambert-shadow"))
    eye_t = torch.as_tensor(eye, dtype=torch.float32, device=dev)

    # try/finally: the unlock must run even when a frame raises (trace
    # error, PNG write failure, Ctrl-C mid-orbit) — otherwise an
    # in-process caller (tests, notebooks) is left with a locked
    # process-global RenderTarget.  The reference unlocks before
    # presenting each frame (`Program.cpp:302-311`).
    try:
        for frame in range(args.frames):
            pan = args.pan + np.deg2rad(args.orbit) * frame
            orient = orient_from_pan_pitch(pan, args.pitch)
            orient_t = torch.as_tensor(orient, dtype=torch.float32,
                                       device=dev)
            # Each route ends with the frame's copy to the host, which
            # waits for the card.
            if shading == "parity":
                with prof.phase("Trace"):
                    err = cam.trace_scene(eye, orient, scene, rt)
                    if err != 0:
                        raise RuntimeError(f"trace error {err}")
                    buf = rt.buffer.cpu()
            elif renderer is not None:
                with prof.phase("Trace"):
                    buf = renderer.render(eye_t, orient_t,
                                          cam.initial_rays).cpu()
            else:
                from raytracercuda_torch.diff.render_grad import render_rgb
                from raytracercuda_torch.trace.shade import pack_shaded

                with prof.phase("Trace"), torch.no_grad():
                    rgb = render_rgb(
                        data, scene.accel, cam.initial_rays, eye_t,
                        orient_t, config,
                        with_shadows=(shading == "lambert-shadow"),
                        frame_hw=(args.size, args.size),
                    )
                    buf = pack_shaded(rgb).cpu()
            with prof.phase("Present"):
                path = os.path.join(args.out, f"frame_{frame:04d}.png")
                write_packed_png(path, buf, args.size, args.size)
            if args.profile:
                prof.report(force=True)
            print(f"wrote {path}")
    finally:
        rt.unlock()
    return 0


if __name__ == "__main__":
    sys.exit(main())
