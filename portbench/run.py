#!/usr/bin/env python3
"""Run one cell of the benchmark of `raytracercuda_torch` once, on one
NVIDIA GPU, and print its result as the last line of standard output.

    python3 portbench/run.py --workload bunny69k.c512.near --seed 7 \
        --seconds 15 --trace 0

Run from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
slice of the window.  Every run checks what the program produced against
the plain reference (`portbench/reference/`) and prints each number
compared beside its limit, last on standard error and under ``checks``
in the result line.  Exits non-zero, printing no result, when there is
no GPU, when the program is missing, or when JAX or the JAX package was
loaded.
"""

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _finite(x):
    """``x`` with every float that is not finite written as null."""
    if isinstance(x, float):
        return x if x == x and abs(x) != float("inf") else None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # Every cache a run may fill stays inside the checkout, at a fixed path.
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, "raytracercuda_torch")):
        print("raytracercuda_torch/ is not in this checkout: nothing to run",
              file=sys.stderr)
        return 2

    import json
    from pathlib import Path

    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload, Path(ROOT))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from raytracercuda_torch.ops import cuda_build

    cuda_build.load_library()

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), device,
                      T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(_finite(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
