"""The traffic kind ``silhouette``: multi-view shape fitting, found by name
(`kinds.load_kind`).

A job photographs the true shape from several views and moves the
vertices toward it, one view a step: Adam on the positions alone, each
step rebuilding the clusters (`accel.clusters.build_clusters`),
rendering through `diff.render_grad.render_rgb_silhouette` (the fixed-id
render and, in its backward, the edge-sampling boundary term of
`diff/edge_grad.py`), taking the mean squared error against that view's
target and its gradient by ``backward()``.  Step i of a job uses view
``i % len(pan_deg)``; a job of ``job_steps`` steps restarts from the
seed's start positions.  Lambert shading with the configuration's light,
no shadows: `render_rgb_silhouette` has no shadow route, so a
configuration that asks for shadows is refused.

A program that traces the probes along their camera-space directions
(before `edge_grad._probe_world`) is refused at once: its term is wrong
under any view but the identity's, and an older program run with these
benchmark files has to fail the cell, not be timed on it.  Set-up builds
the edge table once (`edge_grad.build_edge_table`) and holds it on the
card, the form `render_rgb_silhouette` uses without a copy.  The views
circle the viewed mesh's centre at the configuration's distance, pan and
pitch from the traffic file.  The true shape is the start shape with
mesh ``target_mesh``'s vertices scaled by ``target_scale`` about its
centre; the reference (`reference/render.py`) renders the targets from
it in float32 during set-up, so they are inputs and the program makes
none of them.  A step opens the harness's spans
``rebuild`` (`build_clusters`) and ``backward`` (``loss.backward()``), as
`kinds.AdamJobs` does.

Set-up runs the first ``checked_steps`` steps of the first job.  Their
losses (``loss_gap``), the first step's gradient of the positions as
Adam holds it, ``exp_avg / (1 - b1)`` (``grad_gap``), and the positions'
change over those steps (``change_gap``) are held against
`reference/silhouette.py`, the gradient and the change as vectors:
``|got - want| / |want|`` over every coordinate, so that a boundary term
that is missing or of the wrong sign cannot hide in a norm.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench import traffic as gen
from portbench.kinds import _Scene, sync
from portbench.reference import render as ref
from portbench.reference import silhouette as ref_sil
from portbench.reference.train import AdamSettings

#: Faults planted at `edge_grad.boundary_vjp`: its terms zeroed
#: (``no_boundary``), and the outward normal negated where the term is
#: pulled back to the endpoints (``flipped``: the term's sign flips, its
#: norm stays).
FAULTS = ("no_boundary", "flipped")


def vector_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """``|got - want| / |want|`` over every coordinate, in float64; inf
    where either is not finite or ``want`` is 0."""
    got = got.to(device=want.device, dtype=torch.float64)
    want = want.to(torch.float64)
    scale = float(torch.linalg.vector_norm(want))
    gap = float(torch.linalg.vector_norm(got - want)) / scale if scale \
        else math.inf
    return gap if math.isfinite(gap) else math.inf


def fit_gaps(losses, grad, change, want: ref_sil.Steps) -> dict:
    """The three numbers of the check: the worst relative gap of a step's
    loss, and the vector gaps of the first gradient and of the change."""
    loss = max((abs(a - b) / abs(b) for a, b in zip(losses, want.losses)),
               default=math.inf)
    return {"loss_gap": loss if math.isfinite(loss) else math.inf,
            "grad_gap": vector_gap(grad, want.grad),
            "change_gap": vector_gap(change, want.change)}


class SilhouetteJobs(_Scene):
    def __init__(self, config, traffic, seed, device):
        from raytracercuda_torch.config import DiffConfig
        from raytracercuda_torch.diff import edge_grad

        if not hasattr(edge_grad, "_probe_world"):
            # Such a program traces the probes along their camera-space
            # directions: under a turned view they miss their edges.
            raise RuntimeError(
                "this program does not turn the boundary term's probes "
                "into the world (no edge_grad._probe_world), so its "
                "gradient is wrong under this cell's turned views")
        if config["shadows"]:
            raise ValueError("render_rgb_silhouette has no shadow route: "
                             "the configuration has to say shadows false")
        super().__init__(config, seed, device)
        self.rcfg = dataclasses.replace(self.rcfg, diff=DiffConfig(
            silhouette=True, edge_samples=traffic["edge_samples"],
            edge_offset_px=traffic["edge_offset_px"]))
        self.samples = traffic["edge_samples"]
        self.offset_px = traffic["edge_offset_px"]

        view = config["view"]
        mesh = config["meshes"][view["mesh"]]
        orients = gen.look(np.radians(traffic["pan_deg"]),
                           np.radians(traffic["pitch_deg"]))
        eyes = (np.asarray(mesh["center"], np.float64)
                - view["distance_radii"] * mesh["radius"] * orients[:, :, 2])
        self.eyes = self.tensor(eyes.astype(np.float32))
        self.orients = self.tensor(orients)
        self.views = len(orients)

        self.start_scene = self.reference()
        if not torch.equal(self.data.positions, self.start_scene.positions):
            raise RuntimeError("the program's vertices are not the "
                               "reference's, in order")
        self.rays = ref.camera_rays(self.width, self.height, device=device)
        true = self._true_scene(traffic["target_mesh"],
                                traffic["target_scale"])
        with torch.no_grad():
            self.targets = [ref.render_rgb(
                true, self.eyes[k], self.orients[k], self.rays, self.width,
                self.height, self.shading, False) for k in range(self.views)]

        vids, adjacent = edge_grad.build_edge_table(self.data.faces)
        self.edges = (torch.as_tensor(vids, device=device),
                      torch.as_tensor(adjacent, device=device))

        b1, b2 = traffic["betas"]
        self.adam = AdamSettings(traffic["lr"], b1, b2, traffic["eps"])
        self.job_steps = traffic["job_steps"]
        self.checked_steps = traffic["checked_steps"]
        self.start = self.data.positions.clone()
        self.leaf = self.start.clone().requires_grad_()
        self.opt = torch.optim.Adam([self.leaf], lr=self.adam.lr,
                                    betas=(b1, b2), eps=self.adam.eps)
        self.job = 0
        self.losses, self.grad, self.change = [], None, None
        self.launched, self.units = None, 0  # counts at the window's start
        self.ref_steps = None

    def _true_scene(self, mesh: int, scale: float):
        """The reference's scene with mesh ``mesh``'s vertices scaled by
        ``scale`` about its centre."""
        sizes = [len(m["positions"]) for m in self.inputs.meshes]
        lo = sum(sizes[:mesh])
        centre = self.tensor(self.config["meshes"][mesh]["center"])
        pos = self.start_scene.positions.clone()
        pos[lo:lo + sizes[mesh]] = centre + scale * (
            pos[lo:lo + sizes[mesh]] - centre)
        return self.start_scene._replace(positions=pos)

    def _step(self, tracer):
        from raytracercuda_torch.accel.clusters import build_clusters
        from raytracercuda_torch.diff.render_grad import render_rgb_silhouette

        if self.job == self.job_steps:
            with torch.no_grad():
                self.leaf.copy_(self.start)
            self.opt.state.clear()
            self.job = 0
        k = self.job % self.views
        p = self.leaf
        with tracer.span("rebuild"):
            accel = build_clusters(p.detach(), self.data.faces,
                                   self.rcfg.cluster)
        img = render_rgb_silhouette(
            self.data._replace(positions=p), accel, self.eyes[k],
            self.orients[k], self.rcfg, self.width, self.height,
            light_dir=self.shading.light, edge_table=self.edges)
        loss = torch.mean((img - self.targets[k]) ** 2)
        self.opt.zero_grad(set_to_none=True)
        with tracer.span("backward"):
            loss.backward()
        self.opt.step()
        self.job += 1
        return loss

    def warm_up(self) -> None:
        """The checked steps: the first of the job that the window goes
        on with."""
        from portbench.tracing import Tracer

        idle = Tracer(self.device)
        for step in range(1, self.checked_steps + 1):
            self.losses.append(float(self._step(idle).detach()))
            if step == 1:
                state = self.opt.state[self.leaf]
                # The gradient as Adam holds it (none where it holds no
                # state: a step that left the state unchanged).
                self.grad = (state["exp_avg"] / (1 - self.adam.b1)
                             if "exp_avg" in state
                             else torch.zeros_like(self.start))
        self.change = self.leaf.detach() - self.start
        sync(self.device)

    def unit(self, i: int, tracer) -> None:
        if i == 0:
            from raytracercuda_torch.trace import sweep

            self.launched = dict(sweep.launch_counts)
        self._step(tracer)
        self.units = i + 1

    def end_to_end(self, window_s, latencies) -> dict:
        return {"step_ms": window_s / len(latencies) * 1e3}

    def release(self) -> None:
        super().release()
        self.opt = self.leaf = self.start = None

    def _reference(self, dtype):
        return ref_sil.adam_steps(
            self.start_scene, ref_sil.edge_table(self.start_scene.faces),
            self.eyes, self.orients, self.rays, self.width, self.height,
            self.targets, self.shading, self.adam, self.checked_steps,
            self.samples, self.offset_px, dtype)

    def check(self) -> dict:
        self.ref_steps = self._reference(torch.float32)
        return fit_gaps(self.losses, self.grad, self.change, self.ref_steps)

    def control(self) -> dict:
        low = self._reference(torch.bfloat16)
        return fit_gaps(low.losses, low.grad, low.change,
                        self._reference(torch.float32))

    def notes(self) -> str:
        out = [f"losses {self.losses}"]
        if self.ref_steps is not None:
            out.append("reference (silhouette edges, live samples, counted) "
                       "a checked step " + str(
                           [(b.silhouettes, b.live, b.counted)
                            for b in self.ref_steps.boundary]))
        if self.units:
            from raytracercuda_torch.trace import sweep

            out.append("launches a window step " + str(
                {k: (sweep.launch_counts[k] - self.launched.get(k, 0))
                 / self.units
                 for k in ("primary", "closest_rays", "general_cull")}))
        return "; ".join(out)


KIND = SilhouetteJobs


def plant(fault: str):
    """``(module, attribute, broken)`` of ``fault``: `boundary_vjp` with
    its terms zeroed or negated."""
    from raytracercuda_torch.diff import edge_grad

    def broken(boundary_vjp):
        def terms(*args, **kw):
            out = boundary_vjp(*args, **kw)
            if fault == "no_boundary":
                return tuple(torch.zeros_like(t) for t in out)
            # -n in (dx/dtheta . n): every term negated, exactly.
            return tuple(-t for t in out)
        return terms

    return edge_grad, "boundary_vjp", broken
