"""The numbers that decide ``correct``: each compares what the program
produced in a run with what the reference works out from the same inputs.

  * ``px_off``: the share of a frame's pixels whose colour differs from
    the reference's by more than one level of 255 in any channel, the
    worst of the checked frames (packed frames) or images (float images,
    levels of 1/255).
  * ``loss_gap``: the worst relative gap between a step's loss and the
    reference's, over the checked steps.
  * ``grad_gap``: the worst gap between a leaf's norm of the first
    gradient (as the optimizer holds it) and the reference's, relative to
    the larger of the reference's norm of that leaf and of the median
    leaf.
  * ``change_gap``: the same for each leaf's change over the checked
    steps; leaves whose reference gradient is under a thousandth of the
    median leaf's are left out (Adam moves them by round-off alone).
"""

from __future__ import annotations

import math
import statistics

import torch


def channels(packed: torch.Tensor) -> torch.Tensor:
    """``[N, 3]`` int64 channels of ``0x00RRGGBB`` pixels (uint32 or an
    integer tensor of the same bits)."""
    p = packed.to(torch.int64)
    return torch.stack([(p >> 16) & 255, (p >> 8) & 255, p & 255], 1)


def frame_px_off(frame: torch.Tensor, ref: torch.Tensor) -> float:
    diff = (channels(frame.to(ref.device)) - channels(ref)).abs().amax(1)
    return float((diff > 1).to(torch.float64).mean())


def image_px_off(image: torch.Tensor, ref: torch.Tensor) -> float:
    diff = (image.to(ref.device) - ref).abs().amax(1)
    off = (diff > 1.0 / 255.0) | ~torch.isfinite(diff)
    return float(off.to(torch.float64).mean())


def _gap(got, want, moved=None) -> float:
    scale = statistics.median(want)
    gaps = [abs(g - w) / max(w, scale) for i, (g, w) in
            enumerate(zip(got, want)) if moved is None or i in moved]
    return max((g if math.isfinite(g) else math.inf for g in gaps),
               default=math.inf)


def train_gaps(losses, grad_norms, change_norms, ref) -> dict:
    """The three numbers of a training check: the program's losses and
    norms against the reference's `train.Steps`."""
    ref_grads = [float(g.norm()) for g in ref.grads]
    ref_change = [float(c.norm()) for c in ref.change]
    floor = 1e-3 * statistics.median(ref_grads)
    moved = {i for i, g in enumerate(ref_grads) if g >= floor}
    loss = max((abs(a - b) / abs(b) for a, b in zip(losses, ref.losses)),
               default=math.inf)
    return {"loss_gap": loss if math.isfinite(loss) else math.inf,
            "grad_gap": _gap(grad_norms, ref_grads),
            "change_gap": _gap(change_norms, ref_change, moved)}


def verdict(readings: dict, limits: dict) -> bool:
    """Every limit has its reading, and every reading is at most its
    limit (a NaN is not)."""
    return all(name in readings and readings[name] <= limit
               for name, limit in limits.items())
