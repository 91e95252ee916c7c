"""The traffic kind ``api_orbit``: a library user's viewer loop through the
program's public API, found by name (`kinds.load_kind`).

Set-up builds the scene with `Scene.create` and `Scene.add_mesh`, a
`Camera` with the configuration's ``set_initial_rays`` and a locked
`RenderTarget`.  Each frame does what the reference's TestProgram does
(`Program.cpp:302-332`): ``unlock``, ``lock``, ``Camera.clear`` to the
miss colour and ``Camera.trace_scene`` from the next pose of a periodic
orbit around the first mesh's centre, eye and orientation passed as host
float32 arrays, then one sync, as the reference's present.  A frame whose
calls return a status other than 0 makes the run not correct.  Each
checked frame's target buffer is held, at every pixel, against
`reference/api.py`.
"""

from __future__ import annotations

import torch

from portbench import checks, traffic as gen
from portbench.kinds import OrbitFrames
from portbench.reference import api as ref
from portbench.scenes import make_inputs, port_scene, ref_scene

#: Faults planted at `Camera.trace_scene`: one pixel in a hundred with a
#: wrong red, and the second half of the rays never traced.
FAULTS = ("answer", "half")


class ApiOrbit:
    def __init__(self, config, traffic, seed, device):
        import raytracercuda_torch as rt

        self.config, self.device = config, device
        self.width, self.height = config["width"], config["height"]
        cam = config["camera"]
        self.lens = (cam["left"], cam["right"], cam["top"], cam["bottom"],
                     cam["zoom"])
        self.inputs = make_inputs(config, seed)
        _, self.scene = port_scene(self.inputs, config, device)
        self.cam = rt.Camera.create(device)
        self.target = rt.RenderTarget.create(self.width, self.height, device)
        for call, err in (
                ("set_initial_rays", self.cam.set_initial_rays(
                    self.width, self.height, *self.lens)),
                ("lock", self.target.lock())):
            if err:
                raise RuntimeError(f"{call} returned status {err}")
        first = self.inputs.meshes[0]["positions"]
        self.eyes, self.orients = gen.orbit(
            traffic, config["meshes"][0]["center"],
            config["meshes"][0]["radius"],
            float((first.max(0) - first.min(0)).max()))
        self.period = traffic["period"]
        self.start = gen.start(self.period, seed)
        self.checked = gen.checked(traffic["checked_frames"], self.period,
                                   seed)
        self.warm = traffic["warmup_frames"]
        self.kept = {}
        self.statuses = []  # (frame, statuses) of each frame not all 0

    def _frame(self, k: int) -> torch.Tensor:
        t, cam = self.target, self.cam
        codes = (t.unlock(), t.lock(), cam.clear(t, ref.MISS),
                 cam.trace_scene(self.eyes[k], self.orients[k], self.scene,
                                 t))
        if any(codes):
            self.statuses.append((k, codes))
        return t.buffer

    warm_up = OrbitFrames.warm_up
    unit = OrbitFrames.unit
    end_to_end = OrbitFrames.end_to_end

    def release(self) -> None:
        self.target.unlock()
        self.scene = self.cam = self.target = None

    def _reference(self, scene, k, dtype):
        rays = ref.pinhole_rays(self.width, self.height, *self.lens,
                                device=self.device)
        return ref.render_frame(
            scene, torch.as_tensor(self.eyes[k], device=self.device),
            torch.as_tensor(self.orients[k], device=self.device), rays,
            self.config["t_epsilon"], dtype)

    def check(self) -> dict:
        scene = ref_scene(self.inputs, self.device)
        off = [checks.frame_px_off(self.kept[k],
                                   self._reference(scene, k, torch.float32))
               if k in self.kept else float("inf") for k in self.checked]
        return {"px_off": float("inf") if self.statuses else max(off)}

    def control(self) -> dict:
        scene = ref_scene(self.inputs, self.device)
        return {"px_off": max(checks.frame_px_off(
            self._reference(scene, k, torch.bfloat16),
            self._reference(scene, k, torch.float32)) for k in self.checked)}

    def notes(self) -> str:
        hits = [float((f.to(torch.int64) != ref.MISS).to(torch.float64)
                      .mean()) for f in self.kept.values()]
        return (f"hit share of the checked frames {hits}; frames with a "
                f"status other than 0: {self.statuses[:4]}")


KIND = ApiOrbit


def plant(fault: str):
    """``(module, attribute, broken)`` of ``fault``: `Camera.trace_scene`
    with its target's buffer altered after the trace."""
    from raytracercuda_torch.models.camera import Camera
    from raytracercuda_torch.ops.math import as_bits, as_u32

    def broken(trace_scene):
        def trace(self, eye, orient, scene, target):
            err = trace_scene(self, eye, orient, scene, target)
            bits = as_bits(target.buffer).clone()
            if fault == "answer":  # one pixel in a hundred, a wrong red
                bits[::100] ^= 0x400000
            else:  # the rays of the second half never traced
                bits[bits.numel() // 2:] = ref.MISS
            target.buffer = as_u32(bits)
            return err
        return trace

    return Camera, "trace_scene", broken
