"""No run loads JAX or the JAX package; the check compares whole
top-level names (the program's name begins with the JAX package's)."""

from __future__ import annotations

import subprocess
import sys

from conftest import ROOT
from portbench import harness


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raytracercuda_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert harness.forbidden_modules() == ["jaxlib",
                                           "raytracercuda_tpu.models"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    probe = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + "
        "'/portbench/tests']\n"
        "from conftest import small_cell, run_small\n"
        "for name in ('bunny69k.c512.near', 'armadillo346k-f16.c1024.adam'):\n"
        "    assert run_small(small_cell(name))['correct']\n"
        "from portbench import harness\n"
        "assert 'raytracercuda_torch' in sys.modules\n"
        "assert harness.forbidden_modules() == [], harness.forbidden_modules()\n")
    done = subprocess.run([sys.executable, "-c", probe, str(ROOT)],
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
