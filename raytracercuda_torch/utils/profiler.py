"""Per-phase frame profiler — the ``ProfileItem`` analog
(`TestProgram/Program.h:21-32`, `Program.cpp:358-379`; counterpart of
`raytracercuda_tpu/utils/profiler.py`): named phase stopwatches pushed per
frame, dumped once per second.  A phase given CUDA tensors through
``sync`` ends with `torch.cuda.synchronize` on their device, so it times
the card's work and not its enqueue.  `device_trace` captures a
`torch.profiler` trace around any block, exported as a Chrome trace
(viewable in Perfetto)."""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class ProfileItem:
    name: str
    start: float = 0.0
    end: float = 0.0

    @property
    def elapsed_ms(self) -> float:
        return (self.end - self.start) * 1000.0


def _cuda_devices(sync) -> set:
    """The CUDA devices of ``sync``: a tensor or a list or tuple of them."""
    tensors = [sync] if isinstance(sync, torch.Tensor) else sync or ()
    return {t.device for t in tensors if t.device.type == "cuda"}


@dataclass
class Profiler:
    """Push per-phase timings; ``report()`` prints at most once per
    ``interval`` seconds (the reference prints once per second,
    `Program.cpp:358-373`)."""

    interval: float = 1.0
    items: list[ProfileItem] = field(default_factory=list)
    _last_report: float = 0.0

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase; pass tensors via ``sync`` to wait for the card's
        work on them (the analog of the reference's
        ``cudaDeviceSynchronize()`` "DEBUG" sync points,
        `Program.cpp:297,332`)."""
        item = ProfileItem(name, start=time.perf_counter())
        try:
            yield item
        finally:
            for dev in _cuda_devices(sync):
                torch.cuda.synchronize(dev)
            item.end = time.perf_counter()
            self.items.append(item)

    def push(self, item: ProfileItem) -> None:
        item.end = time.perf_counter()
        self.items.append(item)

    def report(self, force: bool = False) -> str | None:
        now = time.perf_counter()
        if not force and now - self._last_report < self.interval:
            self.items.clear()
            return None
        self._last_report = now
        lines = ["--- Profile Items ---"]
        for item in self.items:
            lines.append(f"{item.name}\t{item.elapsed_ms:.3f}")
        self.items.clear()
        out = "\n".join(lines)
        print(out)
        return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a `torch.profiler` trace of the block (CPU, and CUDA when
    there is a card) into ``log_dir/trace.json``, a Chrome trace — the
    machine-readable successor to the reference's Nsight `aa.xml`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
