"""The loops that drive the program, one per traffic kind, and what each
checks once the window has closed.

A kind is built from a configuration, a traffic file and the seed; its
set-up builds the program's scene, warms up the shapes of its traffic
and nothing else.  ``unit(i, tracer)`` runs unit ``i`` of the window (a
frame, a pass or an Adam step), ``end_to_end`` turns the window into its
metrics, ``release`` drops the program's state, and ``check`` and
``control`` give the numbers of `checks.py`: the program's against the
reference, and the reference's own in bfloat16 against it in float32
(the control, which must come out wrong).

A kind that `KINDS` lacks lives in a file of its own,
``portbench/loops/<kind>.py``, found by name (`kind_class`): its class
``KIND``, its ``FAULTS`` and ``plant(fault)``, which says where each
fault is planted (`faults.planted`).  A new kind adds a file and changes
none.

Only this module, the loops' files, `scenes.port_scene` and the launch
counters of the per-layer readers call the program
(`raytracercuda_torch`); `faults.py` breaks it on purpose, for the tests
and `control.py`.
"""

from __future__ import annotations

import functools
import importlib.util
import statistics
from pathlib import Path

import numpy as np
import torch

from . import checks, traffic as gen
from .reference import bounce as ref_bounce, render as ref
from .reference.train import AdamSettings, adam_steps
from .scenes import make_inputs, port_scene, ref_scene, shading


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _p95(values) -> float:
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 \
        else values[0]


class _Scene:
    """What every kind keeps: the inputs, the program's scene and the
    frame size."""

    def __init__(self, config: dict, seed: int, device: torch.device):
        self.config, self.device = config, device
        self.width, self.height = config["width"], config["height"]
        self.inputs = make_inputs(config, seed)
        self.shading = shading(config)
        self.rcfg, self.scene = port_scene(self.inputs, config, device)
        self.data = self.scene.data()

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def release(self) -> None:
        self.scene = self.data = None

    def reference(self):
        return ref_scene(self.inputs, self.device)

    def notes(self) -> str:
        return ""


class OrbitFrames(_Scene):
    """A viewer's closed loop: each frame is issued when the last one is
    complete on the card, from the next pose of the periodic path."""

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, seed, device)
        from raytracercuda_torch.trace.frame import FrameRenderer

        self.renderer = FrameRenderer(
            self.data, self.scene.accel, self.rcfg, self.height, self.width,
            light_dir=self.shading.light, ambient=self.shading.ambient,
            background=self.shading.background, shadows=config["shadows"])
        pos = np.concatenate([m["positions"] for m in self.inputs.meshes])
        lo, hi = pos.min(0), pos.max(0)
        eyes, orients = gen.orbit(traffic, (lo + hi) / 2,
                                  config["meshes"][0]["radius"],
                                  float((hi - lo).max()))
        self.eyes, self.orients = self.tensor(eyes), self.tensor(orients)
        self.period = traffic["period"]
        self.rays = ref.camera_rays(self.width, self.height, device=device)
        self.start = gen.start(self.period, seed)
        self.checked = gen.checked(traffic["checked_frames"], self.period,
                                   seed)
        self.warm = traffic["warmup_frames"]
        self.kept = {}

    def _frame(self, k: int) -> torch.Tensor:
        return self.renderer.render(self.eyes[k], self.orients[k], self.rays)

    def warm_up(self) -> None:
        for j in range(self.warm):
            self._frame((self.start + j * self.period // self.warm)
                        % self.period)
        sync(self.device)

    def unit(self, i: int, tracer) -> None:
        k = (self.start + i) % self.period
        out = self._frame(k)
        sync(self.device)
        if k in self.checked and k not in self.kept:
            self.kept[k] = out

    def end_to_end(self, window_s, latencies) -> dict:
        return {"frame_ms": window_s / len(latencies) * 1e3,
                "frame_p95_ms": _p95(latencies) * 1e3}

    def release(self) -> None:
        super().release()
        self.renderer = None

    def _reference(self, scene, k, dtype):
        return ref.render_frame(scene, self.eyes[k], self.orients[k],
                                self.rays, self.width, self.height,
                                self.shading, self.config["shadows"], dtype)

    def check(self) -> dict:
        scene = self.reference()
        off = [checks.frame_px_off(self.kept[k],
                                   self._reference(scene, k, torch.float32))
               if k in self.kept else float("inf") for k in self.checked]
        return {"px_off": max(off)}

    def control(self) -> dict:
        scene = self.reference()
        return {"px_off": max(checks.frame_px_off(
            self._reference(scene, k, torch.bfloat16),
            self._reference(scene, k, torch.float32)) for k in self.checked)}

    def notes(self) -> str:
        bg = int(ref.pack(torch.tensor([self.shading.background]))[0])
        hits = [float((f.to(torch.int64) != bg).to(torch.float64).mean())
                for f in self.kept.values()]
        return f"hit share of the checked frames {hits}"


class BounceOrbit(_Scene):
    """`OrbitFrames`' viewer over mirror materials: each frame is the
    program's public bounce entry, `trace.bounce.render_bounces`, with
    ``bounces`` mirror bounces and the configuration's shadows, packed by
    `trace.shade.pack_shaded`, and issued when the last one is complete on
    the card.  Of each checked frame the seed's ``sample_px`` pixels are
    held against the reference (`reference/bounce.py`)."""

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, seed, device)
        import inspect

        from raytracercuda_torch.trace import bounce, bounce_sweep, shade
        from raytracercuda_torch.trace.pipeline import rotate_rays

        ambient = inspect.signature(
            bounce_sweep.render_bounces_tiled).parameters["ambient"].default
        if self.shading.ambient != ambient:
            raise ValueError(
                f"the bounce entry shades with ambient {ambient}; the "
                f"configuration asks for {self.shading.ambient}")
        self.bounce, self.shade, self.rotate = bounce, shade, rotate_rays
        self.accel = self.scene.accel
        self.bounces = traffic["bounces"]
        pos = np.concatenate([m["positions"] for m in self.inputs.meshes])
        lo, hi = pos.min(0), pos.max(0)
        eyes, orients = gen.orbit(traffic, (lo + hi) / 2,
                                  config["meshes"][0]["radius"],
                                  float((hi - lo).max()))
        self.eyes, self.orients = self.tensor(eyes), self.tensor(orients)
        self.period = traffic["period"]
        self.rays = ref.camera_rays(self.width, self.height, device=device)
        self.start = gen.start(self.period, seed)
        self.checked = gen.checked(traffic["checked_frames"], self.period,
                                   seed)
        self.samples = {k: torch.as_tensor(v, device=device) for k, v in
                        gen.sampled(traffic["sample_px"],
                                    self.width * self.height, self.checked,
                                    seed).items()}
        self.warm = traffic["warmup_frames"]
        self.kept = {}
        self.changed = None

    def _frame(self, k: int) -> torch.Tensor:
        rgb = self.bounce.render_bounces(
            self.accel, self.data, self.eyes[k],
            self.rotate(self.rays, self.orients[k]), self.height, self.width,
            self.rcfg, num_bounces=self.bounces, light_dir=self.shading.light,
            with_shadows=self.config["shadows"],
            background=self.shading.background)
        return self.shade.pack_shaded(rgb)

    warm_up = OrbitFrames.warm_up
    unit = OrbitFrames.unit
    end_to_end = OrbitFrames.end_to_end
    _hit_notes = OrbitFrames.notes

    def release(self) -> None:
        super().release()
        self.accel = None

    def _reference(self, scene, k, dtype):
        return ref_bounce.render_sample(
            scene, self.eyes[k], self.orients[k], self.rays, self.width,
            self.height, self.shading, self.config["shadows"], self.bounces,
            self.samples[k], dtype)

    def check(self) -> dict:
        scene = self.reference()
        off, changed = [], []
        for k in self.checked:
            if k not in self.kept:
                off.append(float("inf"))
                continue
            want, flat = self._reference(scene, k, torch.float32)
            got = self.kept[k].to(torch.int64)[self.samples[k]]
            off.append(checks.frame_px_off(got, want))
            changed.append(float((want != flat).to(torch.float64).mean()))
        self.changed = changed
        return {"px_off": max(off)}

    def control(self) -> dict:
        scene = self.reference()
        return {"px_off": max(checks.frame_px_off(
            self._reference(scene, k, torch.bfloat16)[0],
            self._reference(scene, k, torch.float32)[0])
            for k in self.checked)}

    def notes(self) -> str:
        return (f"{self._hit_notes()}; share of the sampled pixels that "
                f"the bounces changed {self.changed}")


class Progressive(_Scene):
    """Jittered passes accumulated into a running mean from the
    configuration's view, each issued when the last is complete;
    restarted every ``passes``.  The first accumulation completed in the
    window is checked."""

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, seed, device)
        eye, orient = gen.view(config)
        self.eye, self.orient = self.tensor(eye), self.tensor(orient)
        self.accel = self.scene.accel
        self.passes = traffic["passes"]
        self.warm = traffic["warmup_passes"]
        self.state = None
        self.kept = None

    def _pass(self) -> None:
        from raytracercuda_torch.trace.progressive import (init_progressive,
                                                           progressive_step)

        if self.state is None or self.state.count == self.passes:
            self.state = init_progressive(self.width * self.height,
                                          device=self.device)
        with torch.no_grad():
            self.state = progressive_step(
                self.state, self.data, self.accel, self.eye, self.orient,
                self.width, self.height, self.rcfg, with_shadows=True)

    def warm_up(self) -> None:
        for _ in range(self.warm):
            self._pass()
        self.state = None
        sync(self.device)

    def unit(self, i: int, tracer) -> None:
        self._pass()
        sync(self.device)
        if self.kept is None and self.state.count == self.passes:
            self.kept = self.state.image

    end_to_end = OrbitFrames.end_to_end

    def release(self) -> None:
        super().release()
        self.accel = self.state = None

    def _reference(self, scene, dtype):
        return ref.progressive_image(scene, self.eye, self.orient, self.width,
                                     self.height, self.passes, self.shading,
                                     True, dtype)

    def check(self) -> dict:
        if self.kept is None:
            return {"px_off": float("inf")}
        return {"px_off": checks.image_px_off(
            self.kept, self._reference(self.reference(), torch.float32))}

    def control(self) -> dict:
        scene = self.reference()
        return {"px_off": checks.image_px_off(
            self._reference(scene, torch.bfloat16),
            self._reference(scene, torch.float32))}


class AdamJobs(_Scene):
    """Inverse rendering: jobs of ``job_steps`` Adam steps on (positions,
    textures), each restarted from the seed's starting parameters.  A step
    rebuilds the structure from the current positions, renders with
    shadows, takes the mean squared error against the target and its
    gradient, and steps Adam.  Set-up takes the first ``checked_steps``
    steps, whose losses, first gradient and changes are checked."""

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, seed, device)
        eye, orient = gen.view(config)
        self.eye, self.orient = self.tensor(eye), self.tensor(orient)
        self.rays = ref.camera_rays(self.width, self.height, device=device)
        self.target = self.tensor(gen.target(self.width, self.height,
                                             traffic["target_waves"], seed))
        b1, b2 = traffic["betas"]
        self.adam = AdamSettings(traffic["lr"], b1, b2, traffic["eps"])
        self.job_steps = traffic["job_steps"]
        self.checked_steps = traffic["checked_steps"]
        self.start = [self.data.positions.clone(), self.data.textures.clone()]
        self.leaves = [x.clone().requires_grad_() for x in self.start]
        self.opt = torch.optim.Adam(self.leaves, lr=self.adam.lr,
                                    betas=(b1, b2), eps=self.adam.eps)
        self.job = 0
        self.losses, self.grad_norms, self.change_norms = [], [], []

    def _step(self, tracer):
        from raytracercuda_torch.accel.clusters import build_clusters
        from raytracercuda_torch.diff.render_grad import l2_image_loss

        if self.job == self.job_steps:
            with torch.no_grad():
                for x, s in zip(self.leaves, self.start):
                    x.copy_(s)
            self.opt.state.clear()
            self.job = 0
        p, tex = self.leaves
        with tracer.span("rebuild"):
            accel = build_clusters(p.detach(), self.data.faces,
                                   self.rcfg.cluster)
        loss = l2_image_loss(self.data._replace(positions=p, textures=tex),
                             accel, self.rays, self.eye, self.orient,
                             self.target, self.rcfg,
                             frame_hw=(self.height, self.width),
                             with_shadows=True)
        self.opt.zero_grad(set_to_none=True)
        with tracer.span("backward"):
            loss.backward()
        self.opt.step()
        self.job += 1
        return loss

    def warm_up(self) -> None:
        """The checked steps: the first of the job that the window goes
        on with."""
        from .tracing import Tracer

        idle = Tracer(self.device)
        for step in range(1, self.checked_steps + 1):
            self.losses.append(float(self._step(idle).detach()))
            if step == 1:
                # The gradient as Adam holds it (none where it holds no
                # state: a step that left the state unchanged).
                self.grad_norms = [
                    float(self.opt.state[x]["exp_avg"].norm()
                          / (1 - self.adam.b1))
                    if "exp_avg" in self.opt.state[x] else 0.0
                    for x in self.leaves]
        self.change_norms = [float((x.detach() - s).norm())
                             for x, s in zip(self.leaves, self.start)]
        sync(self.device)

    def unit(self, i: int, tracer) -> None:
        self._step(tracer)

    def end_to_end(self, window_s, latencies) -> dict:
        return {"step_ms": window_s / len(latencies) * 1e3}

    def release(self) -> None:
        super().release()
        self.opt = self.leaves = self.start = None

    def _reference(self, scene, dtype):
        return adam_steps(scene, self.eye, self.orient, self.rays, self.width,
                          self.height, self.target, self.shading, self.adam,
                          self.checked_steps, dtype)

    def check(self) -> dict:
        return checks.train_gaps(self.losses, self.grad_norms,
                                 self.change_norms,
                                 self._reference(self.reference(),
                                                 torch.float32))

    def control(self) -> dict:
        scene = self.reference()
        low = self._reference(scene, torch.bfloat16)
        return checks.train_gaps(low.losses,
                                 [float(g.norm()) for g in low.grads],
                                 [float(c.norm()) for c in low.change],
                                 self._reference(scene, torch.float32))


KINDS = {"orbit": OrbitFrames, "bounce_orbit": BounceOrbit,
         "progressive": Progressive, "adam": AdamJobs}

#: The kinds that live in a file of their own, one ``<kind>.py`` each.
LOOPS = Path(__file__).resolve().parent / "loops"


@functools.cache
def load_kind(name: str):
    """The module of the traffic kind ``name`` in `LOOPS`, loaded once."""
    path = LOOPS / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no traffic kind {name!r}: not in KINDS, and no "
                       f"{path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_kind_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind_class(name: str):
    """The class that drives traffic of kind ``name``."""
    return KINDS[name] if name in KINDS else load_kind(name).KIND
