"""The probe kernels P1 and P2 (``ops/probe_kernels.py``) and their scripts.

- P1 (the Mosaic feature probes): exact against numpy on the JAX probe's
  inputs, through ``scripts/torch_probe_mosaic_features.py``.  The JAX
  probes pass no ``interpret`` flag and cannot run on a CPU, so numpy is
  their reference here, as in the JAX script.
- P2 (``ydft_energy``): the plain version against the JAX probe's
  ``ydft_energy`` in Pallas interpret mode and its ``ref_energy`` (an
  rfft), at the probe's ``--check`` case ``x [3, 32, 48]``, ``y_chunk=16``:
  relative 1e-5, the probe's own tolerance.  The JAX script is loaded from
  its file, unedited.

Tests marked ``cuda`` launch the kernels and need an NVIDIA GPU; they skip
without one, and import no JAX::

    python -m pytest tests/test_torch_probes.py -m cuda --noconftest
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.ops import fft_kernels as fk
from spectralae_torch.ops import probe_kernels as pk

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
TOL = 1e-5


def _script(name: str):
    """A script of ``scripts/`` loaded as a module, from its file."""
    spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_input(shape=(3, 32, 48), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------- P1

@pytest.mark.parametrize("name", ["lane_strided", "sublane_strided",
                                  "middle_store"])
def test_mosaic_probe_exact_against_numpy(name):
    mosaic = _script("torch_probe_mosaic_features")
    before = _kernels.LAUNCHES.copy()
    ok, line = mosaic.run_case(name, "cpu")
    assert ok and line == f"{name}: OK maxerr=0.0", line
    assert _kernels.LAUNCHES == before     # the CPU takes the plain version


def test_mosaic_probe_script_prints_three_ok_lines(capsys):
    mosaic = _script("torch_probe_mosaic_features")
    assert mosaic.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{n}: OK maxerr=0.0" for n in
                     ("lane_strided", "sublane_strided", "middle_store")]


@pytest.mark.parametrize("fn,shape", [(pk.lane_strided, (3, 10)),
                                      (pk.sublane_strided, (7, 5)),
                                      (pk.middle_store, (2, 3))])
def test_mosaic_probes_take_other_shapes(fn, shape):
    """Ragged strides (a last group of fewer than four) and small tiles."""
    x = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    want = {pk.lane_strided: x[:, 1::4] * 2, pk.sublane_strided:
            x[1::4] * 2, pk.middle_store: torch.stack(
                [x * k for k in (1, 2, 3, 4)])}[fn]
    assert torch.equal(fn(x), want)


@pytest.mark.parametrize("bad", ["dtype", "rank"])
def test_mosaic_probes_reject_what_the_kernels_do_not_take(bad):
    x = torch.zeros(8, 16, dtype=torch.float64 if bad == "dtype"
                    else torch.float32)
    if bad == "rank":
        x = x[None]
    for fn in (pk.lane_strided, pk.sublane_strided, pk.middle_store):
        with pytest.raises(TypeError):
            fn(x)


# ---------------------------------------------------------------- P2

def test_ydft_energy_matches_the_jax_probe():
    """The JAX probe's ``--check``: its Pallas kernel in interpret mode and
    its rfft reference, against the port's plain version."""
    import jax.numpy as jnp
    jprobe = _script("probe_fused_dft")
    x = _check_input()
    want_k = float(jprobe.ydft_energy(jnp.asarray(x), y_chunk=16,
                                      interpret=True))
    want_r = float(jprobe.ref_energy(jnp.asarray(x)))
    before = _kernels.LAUNCHES.copy()
    got = pk.ydft_energy(torch.from_numpy(x), y_chunk=16)
    assert _kernels.LAUNCHES == before
    assert got.dtype == torch.float32 and got.dim() == 0
    for want in (want_k, want_r):
        assert abs(float(got) - want) / abs(want) < TOL
    assert abs(float(pk.ref_energy(torch.from_numpy(x))) - want_r) \
        / abs(want_r) < TOL


@pytest.mark.parametrize("shape", [(3, 32, 48), (2, 17, 33), (1, 64, 7)])
def test_ydft_energy_chunking_is_semantics(shape):
    """Any ``y_chunk`` gives the unchunked energy, and it is the rfft's
    (odd and even ny)."""
    x = torch.from_numpy(_check_input(shape, seed=1))
    ref = float(pk.ref_energy(x))
    for y_chunk in (1, 5, 16, 512):
        got = float(pk.ydft_energy(x, y_chunk=y_chunk))
        assert abs(got - ref) / ref < TOL, y_chunk


def test_ydft_energy_rejects_what_it_does_not_take():
    x = torch.zeros(3, 8, 8)
    with pytest.raises(ValueError, match="precision"):
        pk.ydft_energy(x, precision="tf32")
    with pytest.raises(ValueError, match="y_chunk"):
        pk.ydft_energy(x, y_chunk=0)
    with pytest.raises(TypeError):
        pk.ydft_energy(x[0])
    for tier in pk.PRECISIONS:
        assert float(pk.ydft_energy(x, precision=tier)) == 0.0


def test_fused_dft_probe_script_check(capsys):
    dft = _script("torch_probe_fused_dft")
    assert dft.main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "check on cpu" in out and out.strip().endswith("OK")


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lane_strided", "sublane_strided",
                                  "middle_store"])
def test_mosaic_probe_kernels_on_card(cuda_device, name):
    mosaic = _script("torch_probe_mosaic_features")
    before = _kernels.LAUNCHES[name]
    ok, line = mosaic.run_case(name, "cuda")
    assert ok, line
    assert _kernels.LAUNCHES[name] == before + 1


# each tier's energy against the rfft route: fft_kernels.p2_tier_tol (the
# energy moved 2.9e-4 to 1.8e-3 at these shapes through the plain
# "default" version on the CPU, the most at the smallest)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "high", "highest"])
@pytest.mark.parametrize("shape,y_chunk", [((3, 32, 48), 16),
                                           ((3, 256, 256), 512),
                                           ((2, 100, 130), 7),
                                           ((1, 64, 7), 3)])
def test_ydft_energy_kernel_matches_plain_on_card(cuda_device, shape,
                                                  y_chunk, precision):
    """Partial row and bin tiles, odd ny (no vector loads) and an odd
    chunking, against the tier-matched plain version (its float32 products
    run without TF32) and the rfft route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(_check_input(shape, seed=2)).to(cuda_device)
    before = _kernels.LAUNCHES["ydft_energy"]
    got = float(pk.ydft_energy(x, y_chunk=y_chunk, precision=precision))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["ydft_energy"] == before + 1
    want = float(pk.ydft_energy_plain(x, y_chunk=y_chunk,
                                      precision=precision))
    assert abs(got - want) / want < TOL
    ref = float(pk.ref_energy(x))
    assert abs(got - ref) / ref < fk.p2_tier_tol(precision, x.numel())
