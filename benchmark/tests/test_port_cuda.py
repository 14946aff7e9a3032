"""On the card: the control fails the comparison, a sound program passes
it, and the command prints a result with every metric of its cell."""

import json
import subprocess
import sys

import pytest

from benchmark import control, harness

pytestmark = pytest.mark.cuda

CELLS = ["m10k5.step-fft.1024-b64", "m50k5.step-fft.1024-b16",
         "m10k5.step-coord.1024-b32", "m50k5.step-coord.1024-b16"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(cuda_device, name):
    cell = harness.load_cell(name)
    rows = {r["reading"]: r
            for r in control.readings(cell, 2**31 + 11, cuda_device, True)}
    limits = cell["limits"]
    assert harness.judge(rows["program"], limits)
    assert not harness.judge(rows["program_tf32"], limits)
    assert not harness.judge(rows["half_batch"], limits)


@pytest.mark.parametrize("trace", [0, 1])
def test_command_prints_a_result(cuda_device, trace):
    name = CELLS[0]
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483999", "--seconds", "2", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["correct"] is True
    cell = harness.load_cell(name)
    kind = "per_layer" if trace else "end_to_end"
    assert set(out["metrics"]) == {m["name"] for m in cell["metrics"][kind]}
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"]
    last = list(cell["limits"])[-1]
    assert res.stderr.splitlines()[-1].startswith(f"{last} ")
