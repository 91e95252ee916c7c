"""The benchmark of `raytracercuda_torch` on an NVIDIA GPU: `run.py` runs
one cell of ``BENCHMARK.json``."""
