"""The command without a card, without the program, and with the timed
path broken underneath: no result, or ``correct`` false."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from spectralae_torch.train import modern

CELLS = {"fft": "m10k5.step-fft.1024-b64",
         "coord": "m10k5.step-coord.1024-b32"}


def _tiny(name):
    cell = harness.load_cell(name)
    cell["traffic"].update(nx=64, ny=64, batch=4, ring=4, warmup_steps=1,
                           trace_steps=2, reference_rows=2)
    return cell


def _cmd(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         CELLS["fft"], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def _no_result(res):
    assert res.returncode != 0
    for line in res.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    res = _cmd(harness.ROOT, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    _no_result(res)
    assert "CUDA device" in res.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(harness.ROOT / harness.MANIFEST, tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    _no_result(_cmd(tmp_path))
    code = f"""
import sys, time
sys.path.insert(0, {str(tmp_path)!r})
import torch
from benchmark import harness
cell = harness.load_cell("{CELLS['fft']}")
harness.run(cell, seed=1, seconds=0.1, trace=False,
            device=torch.device("cpu"), t0=time.perf_counter())
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "spectralae_torch" in res.stderr


def test_unknown_workload():
    with pytest.raises(SystemExit):
        harness.load_cell("no.such.cell")


def _unchanged(step):
    def broken(params, opt, x, *args, **kw):
        res = step(params, opt, x, *args, **kw)
        return modern.TrainStepResult(params=params, opt=opt, loss=res.loss)
    return broken


def _half_batch(step):
    def broken(params, opt, x, *args, **kw):
        return step(params, opt, x[: x.shape[0] // 2], *args, **kw)
    return broken


@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch],
                         ids=["sound", "unchanged", "half_batch"])
@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_faults_come_out_incorrect(monkeypatch, domain, fault):
    if fault is not None:
        monkeypatch.setattr(modern, "train_step", fault(modern.train_step))
    cell = _tiny(CELLS[domain])
    out = harness.run(cell, seed=2**31 + 7, seconds=0.2, trace=False,
                      device=torch.device("cpu"), t0=time.perf_counter())
    assert out["correct"] is (fault is None)
    assert list(out["checks"]) == list(cell["limits"])
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"train_frames_per_s", "step_p95_ms",
                                   "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_same_seed_same_inputs():
    from benchmark.entries import step
    cell = _tiny(CELLS["fft"])
    a, b, c = (step.Inputs(cell, s, torch.device("cpu"))
               for s in (2**31 + 3, 2**31 + 3, 5))
    for x, y in zip(a.leaves, b.leaves):
        assert torch.equal(x, y)
    assert torch.equal(a.pattern.batch_at(2), b.pattern.batch_at(2))
    assert not torch.equal(a.pattern.batch_at(2), c.pattern.batch_at(2))
    ring = step.frames.ring(a.pattern, 3)
    assert torch.equal(ring[1], a.pattern.batch_at(1))
    flat = ring.reshape(-1, *ring.shape[2:])
    assert len({hash(f.numpy().tobytes()) for f in flat}) == flat.shape[0]
