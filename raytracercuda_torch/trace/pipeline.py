"""Camera rotation and the closest-hit dispatch (counterpart of
`raytracercuda_tpu/trace/pipeline.py:22-80`).

The port traces pinhole frames of a CLUSTER scene through kernel C
(`sweep.trace_dense`).  The other routes come with later slices of the
port and raise `NotImplementedError` naming theirs; `trace_to_buffer`
comes with the public-API slice.
"""

from __future__ import annotations

import torch

from ..config import AccelKind, RenderConfig
from ..types import Hit


def rotate_rays(initial_rays: torch.Tensor,
                orient: torch.Tensor) -> torch.Tensor:
    """``dir = orient * initialRays[i]``: ``initial_rays @ orient.T``,
    written per component so the three products sum in one fixed order on
    every device (no TF32 on the card)."""
    r = initial_rays
    return (r[:, 0:1] * orient[:, 0] + r[:, 1:2] * orient[:, 1]
            + r[:, 2:3] * orient[:, 2])


def trace_hit(
    scene,
    accel,
    origin: torch.Tensor,
    direction: torch.Tensor,
    config: RenderConfig,
    frame_hw: tuple[int, int] | None = None,
    common_origin: torch.Tensor | None = None,
) -> Hit:
    """Closest hit of row-major rays: the CLUSTER pinhole route (a frame
    of ``frame_hw`` pixels that the tile divides, all rays leaving
    ``common_origin``) through kernel C."""
    del scene, origin  # the pinhole route reads the clusters and the eye
    kind = config.accel
    if kind == AccelKind.BRUTE or accel is None:
        raise NotImplementedError(
            "AccelKind.BRUTE waits for kernel E (the public-API slice of "
            "the port)")
    if kind != AccelKind.CLUSTER:
        raise NotImplementedError(
            f"{kind} waits for slice 6 of the port (the remaining backends)")
    tp = config.trace.dense_tile_px
    if (frame_hw is None or common_origin is None
            or frame_hw[0] % tp or frame_hw[1] % tp):
        raise NotImplementedError(
            "arbitrary ray bundles (no common origin, or a frame the "
            f"{tp}-pixel tile does not divide) wait for kernel F (the "
            "multi-bounce slice of the port)")
    from .sweep import segment_blocks, trace_dense

    return trace_dense(accel, segment_blocks(accel), common_origin,
                       direction, height=frame_hw[0], width=frame_hw[1],
                       tile_px=tp, trace_cfg=config.trace)
