#!/usr/bin/env python3
"""Readings that set a cell's limits, many seeds in one process on one
NVIDIA GPU; the benchmark's own runs never run this.

    python3 portbench/control.py --workload bunny69k.c512.near \
        --seeds 11,12,13 --seconds 3            # the program's readings
    python3 portbench/control.py --workload bunny69k.c512.near \
        --seeds 11,12,13 --control              # the control's

The program's readings are those of a whole run (`harness.run`) with a
window of ``--seconds``; with ``--fault`` (`faults.py`), of a run with
that fault planted in the program.  The control puts the reference, computed in
bfloat16, in the program's place at the cell's own size and compares it
with the reference in float32, exactly as a run compares the program:
a limit must fail it.  One JSON line a seed on standard output.
"""

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    from pathlib import Path

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", help="plant this fault of "
                        "`portbench/faults.py` in the program's runs")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from portbench import harness
    from portbench.faults import planted
    from portbench.kinds import kind_class

    cell = harness.load_cell(args.workload, Path(ROOT))
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.control:
            kind = kind_class(cell.traffic["kind"])(
                cell.config, cell.traffic, seed, device)
            kind.release()
            line = {"seed": seed, "control": kind.control()}
        else:
            with (planted(cell.traffic["kind"], args.fault) if args.fault
                  else contextlib.nullcontext()):
                out = harness.run(cell, seed, args.seconds, False, device,
                                  time.perf_counter())
            line = {"seed": seed, "fault": args.fault,
                    "correct": out["correct"],
                    "readings": {k: v["value"]
                                 for k, v in out["checks"].items()},
                    "metrics": {k: v["value"]
                                for k, v in out["metrics"].items()},
                    "memory_peak_bytes": out["device"]["memory_peak_bytes"]}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
