"""spectralae_torch.model / core.types against the JAX package (CPU).

A small net (D=3, M=4, 5x5, 1-2 pairs, 32^2) with weights drawn by numpy,
built as a JAX ``AEParams`` and carried into the port through
``params_from_numpy``.  Tolerances are norm-relative: 1e-5 for float32
chains through FFTs or several convs (two libraries, sums in another
order); shape math and parameter round trips are exact.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spectralae.core import types as jtypes
from spectralae.core.config import Config, LayerParams
from spectralae.model import autoencoder as jmodel
from spectralae_torch.core import types as ttypes
from spectralae_torch.model import autoencoder as tmodel

torch.set_num_threads(1)

CHAIN_TOL = 1e-5
CFG = Config(nx=32, ny=32, d=3, layer=LayerParams(depth=4))


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def net(pairs: int, seed: int = 0):
    """(JAX params, port params, spec, input) for a ``pairs``-deep net."""
    spec = jtypes.initial_spec(CFG)
    for _ in range(pairs - 1):
        spec = spec.add_pair(CFG.layer)
    rng = np.random.default_rng(seed)
    arrays = [(rng.uniform(-3, 3, (s.m, s.d, s.nk, s.nl)).astype(np.float32),
               rng.uniform(-3, 3, s.m).astype(np.float32))
              for s in spec.stages]
    jparams = jtypes.AEParams(stages=tuple(
        jtypes.ConvStage(c=jnp.asarray(c), b=jnp.asarray(b))
        for c, b in arrays))
    tparams = ttypes.params_from_numpy(
        [(np.asarray(s.c), np.asarray(s.b)) for s in jparams.stages])
    x = rng.uniform(0, 255, (2, CFG.d, CFG.nx, CFG.ny)).astype(np.float32)
    return jparams, tparams, spec, x


@pytest.mark.parametrize("pairs", [1, 2])
def test_forward_fft_matches_jax(pairs):
    jp, tp, spec, x = net(pairs)
    got = tmodel.forward_fft(tp, torch.from_numpy(x), spec.scales)
    want = jmodel.forward_fft(jp, jnp.asarray(x), spec.scales)
    assert got.shape == x.shape
    assert rel(got, want) < CHAIN_TOL


def test_forward_fft_layers_match_jax():
    jp, tp, spec, x = net(2, seed=1)
    got, got_layers = tmodel.forward_fft(tp, torch.from_numpy(x),
                                         spec.scales, return_layers=True)
    want, want_layers = jmodel.forward_fft(jp, jnp.asarray(x), spec.scales,
                                           return_layers=True)
    assert len(got_layers) == len(want_layers) == 2 * len(spec.stages) + 1
    for g, w in zip(got_layers, want_layers):
        assert g.shape == w.shape
        assert rel(g, w) < CHAIN_TOL
    assert got_layers[-1] is got


@pytest.mark.parametrize("tap", ["centered", "ref_cpu", "ref_gpu"])
def test_forward_coord_tape_matches_jax(tap):
    jp, tp, spec, x = net(2, seed=2)
    got = tmodel.forward_coord(tp, torch.from_numpy(x), spec.scales,
                               tap_mode=tap)
    want = jmodel.forward_coord(jp, jnp.asarray(x), spec.scales,
                                tap_mode=tap)
    assert len(got) == len(want) == 2 * len(spec.stages) + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel(g, w) < CHAIN_TOL


@pytest.mark.parametrize("domain,tap", [("fft", "centered"),
                                        ("coord", "centered"),
                                        ("coord", "ref_cpu"),
                                        ("coord", "ref_gpu")])
def test_encode_matches_jax(domain, tap):
    jp, tp, spec, x = net(2, seed=3)
    got = tmodel.encode(tp, torch.from_numpy(x), spec.scales, domain=domain,
                        tap_mode=tap)
    want = jmodel.encode(jp, jnp.asarray(x), spec.scales, domain=domain,
                         tap_mode=tap)
    assert got.shape == want.shape == (2, 4, 8, 8)
    assert rel(got, want) < CHAIN_TOL


def test_tie_symmetric_and_mse_match_jax():
    jp, tp, spec, x = net(2, seed=4)
    for n_l in range(2):
        got = tmodel.tie_symmetric(tp, n_l)
        want = jmodel.tie_symmetric(jp, n_l)
        for g, w in zip(got.stages, want.stages):
            np.testing.assert_array_equal(g.c.numpy(), np.asarray(w.c))
            np.testing.assert_array_equal(g.b.numpy(), np.asarray(w.b))
    y = x[::-1].copy()
    got = float(tmodel.reconstruction_mse(torch.from_numpy(x),
                                          torch.from_numpy(y)))
    want = float(jmodel.reconstruction_mse(jnp.asarray(x), jnp.asarray(y)))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("kw", [{"compute_dtype": torch.float16}])
def test_unported_forward_options_raise(kw):
    # bf16 operands are ported; other reduced types are not
    _, tp, spec, x = net(1)
    with pytest.raises(NotImplementedError, match="bf16 operands only"):
        tmodel.forward_fft(tp, torch.from_numpy(x), spec.scales, **kw)


def test_spec_math_matches_jax():
    from spectralae_torch.core.config import Config as TConfig
    from spectralae_torch.core.config import LayerParams as TLayer
    tcfg = TConfig(nx=48, ny=32, d=3, layer=TLayer(depth=5, lk=0))
    jcfg = Config(nx=48, ny=32, d=3, layer=LayerParams(depth=5, lk=0))
    t, j = ttypes.initial_spec(tcfg), jtypes.initial_spec(jcfg)
    for _ in range(2):
        t, j = t.add_pair(tcfg.layer), j.add_pair(jcfg.layer)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.scales == j.scales and t.inner_shape() == j.inner_shape()
    assert dataclasses.asdict(t.drop_pair()) == dataclasses.asdict(
        j.drop_pair())
    _, tp, _, _ = net(1)
    jp, _, _, _ = net(1)
    assert dataclasses.asdict(ttypes.spec_of(tp, 32, 32, 3, (2, -2))) == \
        dataclasses.asdict(jtypes.spec_of(jp, 32, 32, 3, (2, -2)))
    with pytest.raises(ValueError, match="does not divide"):
        ttypes.initial_spec(TConfig(nx=31, ny=32))


def test_init_params_is_seeded_uniform_and_round_trips():
    from spectralae_torch.core.config import Config as TConfig
    spec = ttypes.initial_spec(TConfig(nx=32, ny=32))
    a = ttypes.init_params(torch.Generator().manual_seed(5), spec, 3.0)
    b = ttypes.init_params(torch.Generator().manual_seed(5), spec, 3.0)
    for sa, sb, ss in zip(a.stages, b.stages, spec.stages):
        assert sa.c.shape == (ss.m, ss.d, ss.nk, ss.nl)
        assert sa.c.dtype == torch.float32
        assert torch.equal(sa.c, sb.c) and torch.equal(sa.b, sb.b)
        assert float(sa.c.abs().max()) <= 3.0
    back = ttypes.params_from_numpy(ttypes.params_to_numpy(a))
    for sa, sb in zip(a.stages, back.stages):
        assert torch.equal(sa.c, sb.c) and torch.equal(sa.b, sb.b)


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = ["spectralae_torch", "spectralae_torch._kernels",
            "spectralae_torch.core.config", "spectralae_torch.core.types",
            "spectralae_torch.ops.spectral", "spectralae_torch.ops.dft",
            "spectralae_torch.ops.spectral_kernels",
            "spectralae_torch.ops.coord",
            "spectralae_torch.ops.coord_kernels",
            "spectralae_torch.model.autoencoder",
            "spectralae_torch.optim.update", "spectralae_torch.train.modern",
            "spectralae_torch.core.profiling",
            "spectralae_torch.io.checkpoint", "spectralae_torch.io.export",
            "spectralae_torch.io.server", "spectralae_torch.data.pipeline",
            "spectralae_torch.viz.png", "spectralae_torch.cli.main"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'spectralae' or "
            "m.startswith('spectralae.'))\n"
            "print(bad)\n")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
