#!/usr/bin/env python3
"""Profile the host side of config 4's grad step on one NVIDIA GPU.

Run from the root of a checkout: ``python3 profile_grad_step.py [--tree DIR]
[--standalone] [--label NAME] [--out DIR]``.  DIR (default: this checkout)
is the checkout whose `chip_smoke.py` and `raytracercuda_torch` run, so
that two commits are held to one instrument.  By default it runs DIR's
`chip_smoke.py` up to the end of phase 13 and measures where phase 13
times the grad step by events, after every phase before it; the phases
after 13 are skipped.  With ``--standalone`` it builds only config 4's
scene, as `chip_smoke.py` does, and measures a fresh grad step.

It prints one JSON line, keyed by NAME:

  * ``events_ms``: phase 13's event time (5 steps) taken three times;
  * ``no_gc_events_ms``: the same with Python's garbage collector off;
  * ``wall_ms``, ``main_cpu_ms``, ``process_cpu_ms``: per step over 20
    steps, the wall clock, the main thread's CPU time and every thread's
    CPU time; ``threads_cpu_ms``: each thread that used more than 5 ms
    of CPU in those steps, by name;
  * ``gc``: collections per generation and their ms over those steps,
    and the objects the collector tracks;
  * ``allocator``: the caching allocator's cudaMalloc and cudaFree calls
    over those steps, its retries and segments;
  * ``threads``: torch's intra-op threads, the CPUs the process may use,
    the load average;
  * ``cpu_ops``: the operators with the most self CPU time per step under
    `torch.profiler` with only the CPU traced, then ``runtime_ops`` the
    same with the card traced too (the CUDA runtime calls appear there).

The profilers' tables go to ``DIR/grad_host_<NAME>.txt`` (``--out``,
default ``chiprun_out``).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time

STEPS = 20
TOP = 25


class _Stop(Exception):
    """Raised after phase 13 to skip `chip_smoke.py`'s later phases."""


def thread_cpu() -> dict:
    """CPU seconds (user + system) of each thread of this process, keyed
    by ``name/tid``."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        name = stat[stat.index("(") + 1:stat.rindex(")")]
        fields = stat[stat.rindex(")") + 2:].split()
        out[f"{name}/{tid}"] = (int(fields[11]) + int(fields[12])) / tick
    return out


def op_rows(prof, steps: int) -> list:
    """The `TOP` operators with the most self CPU time: (name, calls per
    step, self CPU ms per step)."""
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [(e.key[:60], round(e.count / steps, 1),
             round(e.self_cpu_time_total / 1e3 / steps, 4))
            for e in rows[:TOP] if e.self_cpu_time_total > 0]


def measure(step, time_cuda, label: str, out_dir: str) -> dict:
    """Every measurement of the module docstring on ``step``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    res = {"label": label}
    res["events_ms"] = [round(time_cuda(step, 5), 4) for _ in range(3)]
    gc.disable()
    try:
        res["no_gc_events_ms"] = [round(time_cuda(step, 5), 4)
                                  for _ in range(2)]
    finally:
        gc.enable()

    collections = {0: [0, 0.0], 1: [0, 0.0], 2: [0, 0.0]}
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            c = collections[info["generation"]]
            c[0] += 1
            c[1] += (time.perf_counter() - started.pop("t")) * 1e3

    step()
    torch.cuda.synchronize()
    stats0 = torch.cuda.memory_stats()
    threads0 = thread_cpu()
    gc.callbacks.append(on_gc)
    try:
        wall0, main0 = time.perf_counter(), time.thread_time()
        proc0 = sum(os.times()[:2])
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
        main = time.thread_time() - main0
        proc = sum(os.times()[:2]) - proc0
    finally:
        gc.callbacks.remove(on_gc)
    threads1 = thread_cpu()
    stats1 = torch.cuda.memory_stats()
    res["wall_ms"] = round(wall * 1e3 / STEPS, 4)
    res["main_cpu_ms"] = round(main * 1e3 / STEPS, 4)
    res["process_cpu_ms"] = round(proc * 1e3 / STEPS, 4)
    res["threads_cpu_ms"] = {
        k: round((v - threads0.get(k, 0.0)) * 1e3 / STEPS, 2)
        for k, v in threads1.items() if v - threads0.get(k, 0.0) > 0.005}
    res["gc"] = {"per_generation": {g: [n, round(ms, 3)]
                                    for g, (n, ms) in collections.items()},
                 "tracked_objects": len(gc.get_objects())}

    def delta(key):
        return stats1.get(key, 0) - stats0.get(key, 0)

    res["allocator"] = {
        "cudaMalloc": delta("num_device_alloc"),
        "cudaFree": delta("num_device_free"),
        "alloc_retries": delta("num_alloc_retries"),
        "segments": stats1.get("segment.all.current"),
        "reserved_GiB": round(stats1.get("reserved_bytes.all.current", 0)
                              / 2 ** 30, 3),
        "allocated_GiB": round(stats1.get("allocated_bytes.all.current", 0)
                               / 2 ** 30, 3)}
    res["threads"] = {"torch_intra_op": torch.get_num_threads(),
                      "cpus_allowed": len(os.sched_getaffinity(0)),
                      "process_threads": len(os.listdir("/proc/self/task")),
                      "loadavg": os.getloadavg()}

    tables = []
    for key, activities in (
            ("cpu_ops", [ProfilerActivity.CPU]),
            ("runtime_ops", [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        step()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        res[key] = op_rows(prof, 5)
        tables.append(f"== {key} (5 steps)\n" + prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=60))
    path = os.path.join(out_dir, f"grad_host_{label}.txt")
    with open(path, "w") as f:
        f.write("\n".join(tables))
    res["tables"] = path
    return res


def load_smoke(tree: str):
    """``tree``'s `chip_smoke` module, with ``tree`` first on the path so
    that it imports ``tree``'s package."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def standalone(cs, label: str, out_dir: str) -> dict:
    """Config 4's scene and grad step alone, as `chip_smoke.diff_path`
    makes them."""
    import torch

    from raytracercuda_torch.diff import render_grad
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    cuda_build.build()
    cuda_build.load_library()
    config, data, accel, eye, orient = cs.config4_scene(
        dev, cs.C4_ARMADILLO, cs.C4_F16)
    size = cs.C4_SIZE
    rays = camera_ray_grid(size, size, device=dev)
    zero = torch.zeros((size * size, 3), device=dev)

    def grad_step():
        p = data.positions.detach().clone().requires_grad_()
        t = data.textures.detach().clone().requires_grad_()
        loss = render_grad.l2_image_loss(
            data._replace(positions=p, textures=t), accel, rays, eye, orient,
            zero, config, frame_hw=(size, size), with_shadows=False)
        loss.backward()
        return loss.detach(), p.grad, t.grad

    return measure(grad_step, cs.time_cuda, label, out_dir)


def in_context(cs, label: str, out_dir: str) -> dict:
    """Run ``cs.main`` to the end of phase 13, measuring where phase 13
    first times the grad step."""
    found = {}
    time_cuda, diff_path = cs.time_cuda, cs.diff_path

    def timed(fn, iters):
        if getattr(fn, "__name__", "") == "grad_step" and not found:
            found["res"] = measure(fn, time_cuda, label, out_dir)
        return time_cuda(fn, iters)

    def through_phase_13(*args, **kwargs):
        diff_path(*args, **kwargs)
        raise _Stop

    cs.time_cuda, cs.diff_path = timed, through_phase_13
    try:
        cs.main()
    except _Stop:
        pass
    if "res" not in found:
        cs.fail("phase 13 never timed a function named grad_step")
    return found["res"]


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=here)
    parser.add_argument("--standalone", action="store_true")
    parser.add_argument("--label", default="grad_step")
    parser.add_argument("--out", default=os.path.join(here, "chiprun_out"))
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    cs = load_smoke(os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: profiling needs a GPU")
    run = standalone if args.standalone else in_context
    print(json.dumps(run(cs, args.label, args.out)))


if __name__ == "__main__":
    main()
