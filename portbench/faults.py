"""Faults planted in the program's timed path, to show that a run with one
of them comes out not correct (`tests/test_portbench_faults.py` on the
CPU; `control.py --fault` on the card, where a training cell's faults
also give the upper readings of its limits).

Each cell can have: an answer altered where it is produced (``answer``),
half of the batch left out (``half``) and, where a step carries state, a
step that returns its state unchanged (``state``).  A frame with mirror
bounces can also lose its materials' reflectivity (``reflectivity``).
There is one chip, so no exchange between chips to leave out.  A kind
that lives in a file of its own (`kinds.load_kind`) gives its faults and
where each is planted there.
"""

from __future__ import annotations

import contextlib

import torch

from .kinds import load_kind

#: The faults each traffic kind of `kinds.KINDS` can have.
FAULTS = {"orbit": ("answer", "half"),
          "bounce_orbit": ("answer", "half", "reflectivity"),
          "progressive": ("state", "answer", "half"),
          "adam": ("state", "answer", "half")}


def faults_of(kind: str) -> tuple:
    """The faults a cell of traffic ``kind`` can have."""
    return FAULTS[kind] if kind in FAULTS else load_kind(kind).FAULTS


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """Plant ``fault`` in the program for the cells of traffic ``kind``;
    undone on exit."""
    if fault not in faults_of(kind):
        raise ValueError(f"a {kind} cell has no fault {fault!r}")
    plant = ({"orbit": _frames, "bounce_orbit": _bounces,
              "progressive": _progressive, "adam": _adam}.get(kind)
             or load_kind(kind).plant)
    target, attr, broken = plant(fault)
    saved = getattr(target, attr)
    setattr(target, attr, broken(saved))
    try:
        yield
    finally:
        setattr(target, attr, saved)


def _frames(fault):
    from raytracercuda_torch.ops.math import as_bits, as_u32
    from raytracercuda_torch.trace.frame import FrameRenderer

    def broken(render):
        def frame(self, eye, orient, rays):
            bits = as_bits(render(self, eye, orient, rays)).clone()
            if fault == "answer":  # one pixel in a hundred, a wrong red
                bits[::100] ^= 0x400000
            else:  # the rays of the second half never traced
                bits[bits.numel() // 2:] = 255 << 8
            return as_u32(bits)
        return frame

    return FrameRenderer, "render", broken


def _bounces(fault):
    from raytracercuda_torch.trace import bounce

    def broken(render):
        def frame(cs, scene, *args, **kw):
            if fault == "reflectivity":  # every material a plain one
                return render(cs, scene._replace(
                    reflectivity=torch.zeros_like(scene.reflectivity)),
                    *args, **kw)
            rgb = render(cs, scene, *args, **kw).clone()
            if fault == "answer":  # one pixel in a hundred, a wrong red
                rgb[::100, 0] = (rgb[::100, 0] + 0.5) % 1.0
            else:  # the rays of the second half never traced
                rgb[rgb.shape[0] // 2:] = torch.tensor(kw["background"])
            return rgb
        return frame

    return bounce, "render_bounces", broken


def _progressive(fault):
    from raytracercuda_torch.trace import progressive

    if fault == "state":
        def broken(step):
            def unchanged(state, *args, **kw):
                return state._replace(count=state.count + 1)
            return unchanged
        return progressive, "progressive_step", broken

    def broken(render):
        def image(*args, **kw):
            rgb = render(*args, **kw).clone()
            if fault == "answer":  # one pixel in fifty, a wrong red
                rgb[::50, 0] += 0.1
            else:
                rgb[rgb.shape[0] // 2:] = torch.tensor([0.0, 1.0, 0.0])
            return rgb
        return image

    return progressive, "render_rgb", broken


def _adam(fault):
    from raytracercuda_torch.diff import render_grad

    if fault == "state":
        def broken(step):
            def unchanged(self, closure=None):
                return None
            return unchanged
        return torch.optim.Adam, "step", broken

    def broken(loss_of):
        def loss(scene, accel, rays, eye, orient, target, config, **kw):
            if fault == "answer":  # the loss one percent high
                return loss_of(scene, accel, rays, eye, orient, target,
                               config, **kw) * 1.01
            img = render_grad.render_rgb(scene, accel, rays, eye, orient,
                                         config, **kw)
            n = img.shape[0] // 2  # the mean over the first half alone
            return torch.mean((img[:n] - target[:n]) ** 2)
        return loss

    return render_grad, "l2_image_loss", broken
