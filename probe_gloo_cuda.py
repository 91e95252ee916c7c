#!/usr/bin/env python3
"""Which collectives gloo carries on CUDA tensors, two ranks on card 0.

Run from the root of a checkout on a machine with a GPU:
``python3 probe_gloo_cuda.py``.  For each operation (an all-reduce, an
all-gather, and a send/receive pair through `batch_isend_irecv`, as
`raytracercuda_torch/parallel/ring.py` uses it) two spawned processes
join a gloo group through a ``file://`` store in a temporary directory
and run it once on CUDA tensors.  The last line is one JSON object: per
operation ``true`` when both ranks got the right values, else the error
a rank raised or how the ranks ended (gloo may abort a process from its
transport thread).  This decides which of the port's distributed paths
`chip_smoke.py` runs as two ranks on one card (phase 47): the shard
functions need the first two, the ring the third.  Exits non-zero
without a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

OPS = ("all_reduce", "all_gather", "send_recv")
TIMEOUT = 120  # seconds for one operation's two ranks


def rank_body(rank: int, directory: str, op: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(directory, "store"),
        world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    mine = torch.full((1024,), rank + 1.0, device=dev)
    try:
        if op == "all_reduce":
            dist.all_reduce(mine)
            got = [float(mine[0])] == [3.0]
        elif op == "all_gather":
            parts = [torch.empty_like(mine) for _ in range(2)]
            dist.all_gather(parts, mine)
            got = [float(p[0]) for p in parts] == [1.0, 2.0]
        else:
            theirs = torch.empty_like(mine)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, mine, 1 - rank),
                    dist.P2POp(dist.irecv, theirs, 1 - rank)]):
                req.wait()
            got = float(theirs[0]) == 2.0 - rank
        torch.cuda.synchronize()
    except RuntimeError as e:  # the capability this probe reports
        got = repr(e)[:200]
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(got, f)
    dist.destroy_process_group()


def run(op: str):
    """``True``, or what went wrong, for one operation on two ranks."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(rank_body, args=(d, op), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + TIMEOUT
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    return f"no answer within {TIMEOUT} s"
        except (mp.ProcessExitedException, mp.ProcessRaisedException) as e:
            return f"the ranks ended: {e}"[:200]
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        got = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                got.append(json.load(f))
    return True if got == [True, True] else got


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_gloo_cuda.py needs a GPU")
    print(json.dumps({op: run(op) for op in OPS}))


if __name__ == "__main__":
    main()
