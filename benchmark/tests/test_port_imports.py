"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if "out" not in p.relative_to(harness.HERE).parts)


def _top_names(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not _top_names(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted((harness.HERE / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert _top_names(path) <= {"__future__", "contextlib", "math", "torch"}


def test_forbidden_names_are_whole():
    mods = dict(sys.modules)
    try:
        sys.modules["spectralae_torch_like"] = sys
        assert "spectralae" not in harness.forbidden_modules()
        sys.modules["spectralae.ops"] = sys
        assert "spectralae" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def test_a_run_loads_no_jax():
    """A whole run, at a tiny size on the CPU, in a fresh process."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(harness.ROOT)!r})
import torch
from benchmark import harness
cell = harness.load_cell("m10k5.step-fft.1024-b64")
cell["traffic"].update(nx=64, ny=64, batch=2, ring=3, warmup_steps=1,
                       trace_steps=2, reference_rows=2)
out = harness.run(cell, seed=3, seconds=0.1, trace=True,
                  device=torch.device("cpu"), t0=time.perf_counter())
print(json.dumps([harness.forbidden_modules(),
                  "spectralae_torch" in sys.modules, out["correct"]]))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.splitlines()[-1]) == [[], True, True]
