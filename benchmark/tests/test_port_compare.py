"""The comparison's numbers on hand-made steps, on the CPU."""

import math

import pytest
import torch

from benchmark import compare


def _steps(seed=0):
    """Two leaves, one step: the reference's gradient and update, and a
    program's weights that follow them exactly."""
    g = torch.Generator().manual_seed(seed)
    grads = [torch.randn(40, generator=g, dtype=torch.float64) * 1e6,
             torch.randn(5, generator=g, dtype=torch.float64) * 1e6]
    dw = [0.02 * torch.sign(t) for t in grads]
    w0 = [torch.rand(t.shape, generator=g, dtype=torch.float64)
          for t in grads]
    ref = {"losses": [2.0], "grads": [grads], "updates": [dw]}
    prog = {"losses": [2.0], "grad1": [t.clone() for t in grads],
            "params": [w0, [a - b for a, b in zip(w0, dw)]]}
    return prog, ref


def test_a_sound_step_reads_nought():
    prog, ref = _steps()
    out = compare.readings(prog, ref)
    assert out == pytest.approx({"loss_gap": 0.0, "grad_gap": 0.0,
                                 "update_gap": 0.0}, abs=1e-12)


def test_a_sign_that_rounding_decides_is_left_out():
    prog, ref = _steps()
    ref["grads"][0][0][3] = (compare.ROUNDED / 10
                             * ref["grads"][0][0].abs().max())
    prog["params"][1][0][3] += 0.04 + 0.02
    assert compare.readings(prog, ref)["update_gap"] < 1e-12


def test_a_sign_that_rounding_cannot_decide_counts():
    prog, ref = _steps()
    i = int(ref["grads"][0][0].abs().argmax())
    prog["params"][1][0][i] += 0.04 + 0.02
    assert compare.readings(prog, ref)["update_gap"] > 1e-2


@pytest.mark.parametrize("scale", [0.0, 2.0])
def test_a_step_left_unchanged_or_doubled(scale):
    prog, ref = _steps()
    w0, w1 = prog["params"]
    prog["params"][1] = [a + scale * (b - a) for a, b in zip(w0, w1)]
    assert compare.readings(prog, ref)["update_gap"] == pytest.approx(1.0)


def test_a_dead_leaf_is_not_compared():
    prog, ref = _steps()
    ref["grads"][0][1] *= 1e-9
    prog["params"][1][1] = prog["params"][0][1] + 1.0
    assert compare.readings(prog, ref)["update_gap"] < 1e-12


def test_a_missing_step_is_not_a_number():
    prog, ref = _steps()
    prog["params"] = prog["params"][:1]
    prog["losses"] = []
    out = compare.readings(prog, ref)
    assert math.isinf(out["loss_gap"]) and math.isinf(out["update_gap"])
