"""The one generator of traffic: camera poses, the frames to check and
the target image, from a traffic file's parameters and the run's seed.

A traffic file (``portbench/traffic/<name>.json``) is data only; its
``kind`` names the loop that drives the program (`kinds.py`):

  * ``orbit``: a closed loop of frames whose eye circles the scene's
    centre, periodic in ``period`` frames: pan ``pan_deg_per_frame``, pitch
    a sinusoid of amplitude ``pitch_deg`` over the period, distance swept
    ``distance_cycles`` times a period between ``distance`` [lo, hi] in
    units of the first mesh's radius (``distance_unit`` ``radius``) or of
    the scene box's largest side (``extent``).  The seed picks where on
    the path the run starts and which ``checked_frames`` poses are
    checked.
  * ``bounce_orbit``: the same path and closed loop over frames with
    ``bounces`` mirror bounces; of each checked frame the seed draws the
    ``sample_px`` pixels that are checked.
  * ``progressive``: passes of jittered accumulation from the
    configuration's view, restarted every ``passes``.
  * ``adam``: optimisation jobs of ``job_steps`` Adam steps from the
    seed's starting parameters toward the seed's smooth target image.
"""

from __future__ import annotations

import numpy as np

from .scenes import CHECKED, PATH, SAMPLE, TARGET, rng


def look(pan: np.ndarray, pitch: np.ndarray) -> np.ndarray:
    """Camera orientations ``[P, 3, 3]`` (columns: right, up, forward),
    yaw ``pan`` about +y after pitch ``pitch`` about +x, in radians."""
    cy, sy, cp, sp = np.cos(pan), np.sin(pan), np.cos(pitch), np.sin(pitch)
    zero, one = np.zeros_like(pan), np.ones_like(pan)
    yaw = np.stack([np.stack([cy, zero, sy], -1), np.stack([zero, one, zero], -1),
                    np.stack([-sy, zero, cy], -1)], -2)
    pit = np.stack([np.stack([one, zero, zero], -1),
                    np.stack([zero, cp, -sp], -1),
                    np.stack([zero, sp, cp], -1)], -2)
    return (yaw @ pit).astype(np.float32)


def orbit(traffic: dict, center, radius: float, extent: float):
    """The path's poses: ``(eyes [P, 3], orients [P, 3, 3])`` float32."""
    period = traffic["period"]
    k = np.arange(period, dtype=np.float64)
    phase = 2 * np.pi * k / period
    orient = look(np.radians(traffic["pan_deg_per_frame"]) * k,
                  np.radians(traffic["pitch_deg"]) * np.sin(phase))
    unit = radius if traffic["distance_unit"] == "radius" else extent
    lo, hi = traffic["distance"]
    dist = unit * (lo + (hi - lo) * 0.5
                   * (1 - np.cos(traffic["distance_cycles"] * phase)))
    eyes = np.asarray(center, np.float64) - dist[:, None] * orient[:, :, 2]
    return eyes.astype(np.float32), orient


def start(period: int, seed: int) -> int:
    """Where on a periodic path the run starts."""
    return int(rng(seed, PATH).integers(period))


def checked(count: int, choices: int, seed: int) -> list:
    """The ``count`` units of ``choices`` whose outputs are checked."""
    return sorted(rng(seed, CHECKED).choice(choices, count,
                                            replace=False).tolist())


def sampled(count: int, pixels: int, frames, seed: int) -> dict:
    """For each of ``frames`` in turn, ``count`` of its ``pixels`` drawn
    without repeats (all of them where ``count`` is not less), sorted."""
    gen = rng(seed, SAMPLE)
    return {k: (np.arange(pixels) if count >= pixels else
                np.sort(gen.choice(pixels, count, replace=False)))
            for k in frames}


def view(config: dict):
    """A configuration's fixed view: ``(eye [3], orient [3, 3])``
    float32, ``distance_radii`` of the viewed mesh's radius back from its
    centre along the view direction."""
    v = config["view"]
    m = config["meshes"][v["mesh"]]
    orient = look(np.radians([v["pan_deg"]]), np.radians([v["pitch_deg"]]))[0]
    eye = (np.asarray(m["center"], np.float64)
           - v["distance_radii"] * m["radius"] * orient[:, 2])
    return eye.astype(np.float32), orient


def target(width: int, height: int, waves: int, seed: int) -> np.ndarray:
    """A smooth RGB image ``[H*W, 3]`` float32 in (0, 1): per channel,
    0.5 plus ``waves`` plane waves of 0.495 / waves amplitude, each of
    at most 3 cycles across the frame along each axis, in a seeded
    direction and phase."""
    gen = rng(seed, TARGET)
    y, x = np.meshgrid(np.arange(height) / height, np.arange(width) / width,
                       indexing="ij")
    img = np.full((height, width, 3), 0.5)
    for c in range(3):
        for _ in range(waves):
            fx, fy = gen.uniform(-3, 3, 2)
            img[..., c] += 0.5 / waves * 0.99 * np.sin(
                2 * np.pi * (fx * x + fy * y) + gen.uniform(0, 2 * np.pi))
    return img.reshape(-1, 3).astype(np.float32)
