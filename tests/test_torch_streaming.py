"""The port's streaming trainers against the JAX package (CPU).

- ``stream_bursts`` (single and batched frames, momentum carried or not,
  ``maxdiff``, ``reanchor_every``, the bf16 window route),
  ``stream_bursts_pair`` (pair 1 of a 2-pair net) and ``stream_bursts_sweep``
  against JAX's ``fft_stream``/``fft_stream_pair``/``fft_stream_sweep``
  over 3 frames, from the same numpy frames and weights (parameters
  converted from JAX, with non-zero biases).
- ``stream_bursts`` against ``stream_reference_loop`` (bursts anchored on
  an explicit pixel-space forward), and ``_pair_input`` against
  ``forward_fft``'s layers.

Tolerances: weights and momentum 1e-5 norm-relative, ``mses`` 1e-4
relative per entry — three frames of float32 FFT precomputes through two
libraries, each feeding a burst whose update normalises every gradient
entry (test_torch_fft_corr.py).  ``_pair_input``: 1e-5 norm-relative (one
or two float32 stages).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spectralae.core import types as jtypes
from spectralae.core.config import Config, LayerParams
from spectralae.train import streaming as jstream
from spectralae_torch.core import types as ttypes
from spectralae_torch.model import autoencoder as tmodel
from spectralae_torch.train import streaming as tstream
from torch_dist_worker import world  # noqa: F401 (a fixture)

torch.set_num_threads(1)

W_TOL = 1e-5
MSE_RTOL = 1e-4


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def stream_problem(k=3, b=None, d=3, m=4, n=16, nk=3, seed=0):
    rng = np.random.default_rng(seed)
    shape = (k, d, n, n) if b is None else (k, b, d, n, n)
    xs = (rng.normal(size=shape) * 20).astype(np.float32)
    c = (rng.normal(size=(m, d, nk, nk)) * 0.3).astype(np.float32)
    f = (rng.normal(size=(d, m, nk, nk)) * 0.3).astype(np.float32)
    bb = (rng.normal(size=m) * 0.5).astype(np.float32)
    p = (rng.normal(size=d) * 0.5).astype(np.float32)
    return xs, c, f, bb, p


def both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def assert_stream(got, want):
    for name in ("c", "f", "b", "p"):
        assert rel(getattr(got, name), getattr(want, name)) < W_TOL, name
    for i, (g, w) in enumerate(zip(got.mom, want.mom)):
        assert rel(g, w) < W_TOL, f"mom[{i}]"
    assert tuple(got.mses.shape) == tuple(want.mses.shape)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=MSE_RTOL)


STREAMS = {
    "carry": dict(),
    "no_carry": dict(carry_momentum=False),
    "batched": dict(b=2),
    "maxdiff": dict(maxdiff=True),
    "reanchor": dict(iters=9, reanchor_every=4),
    "bf16_windows": dict(b=2, pallas_windows="bf16"),
    "nk5": dict(nk=5, n=20),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_stream_bursts_matches_jax(case):
    kw = dict(STREAMS[case])
    shape = {k: kw.pop(k) for k in ("b", "nk", "n") if k in kw}
    kw.setdefault("iters", 6)
    j, t = both(stream_problem(seed=len(case), **shape))
    want = jstream.fft_stream(*j, lr=0.2, **kw)
    got = tstream.stream_bursts(*t, lr=0.2, **kw)
    assert_stream(got, want)


def test_stream_bursts_equals_the_reference_loop():
    """Fused re-anchoring per frame ≡ bursts anchored on the explicit
    forward, frame by frame (test_streaming.py)."""
    t = both(stream_problem(k=3, b=2, seed=4))[1]
    got = tstream.stream_bursts(*t, iters=8)
    want = tstream.stream_reference_loop(*t, iters=8)
    assert_stream(got, want)


def _net(seed=0, n=16):
    """A 2-pair JAX net (3×3 kernels, pool scale 2) with non-zero biases
    and its port, converted from it."""
    cfg = Config(nx=n, ny=n, d=3, layer=LayerParams(depth=4, lk=1, ll=1,
                                                    scale=2, rmax=0.4))
    spec = jtypes.initial_spec(cfg).add_pair(cfg.layer)
    jp = jtypes.init_params(jax.random.key(seed), spec, cfg.layer.rmax)
    tp = ttypes.params_from_numpy([(np.asarray(s.c), np.asarray(s.b))
                                   for s in jp.stages])
    return jp, tp, spec


def _frames(seed, k=3, b=2, n=16):
    xs = np.random.default_rng(seed).normal(size=(k, b, 3, n, n))
    return (xs * 20).astype(np.float32)


def test_pair_input_matches_forward_layers():
    """_pair_input == forward_fft(return_layers=True)'s pooled-input
    activation layers[2·n_l+1], and equals JAX's."""
    jp, tp, spec = _net()
    x = _frames(1)[0]
    _, layers = tmodel.forward_fft(tp, torch.from_numpy(x), spec.scales,
                                   return_layers=True)
    for n_l in range(spec.n_pairs):
        got = tstream._pair_input(tp, torch.from_numpy(x), spec.scales, n_l)
        assert rel(got, layers[2 * n_l + 1]) < 1e-5
        want = jstream._pair_input(jp, jnp.asarray(x), spec.scales, n_l)
        assert rel(got, want) < 1e-5


def test_stream_bursts_pair_matches_jax():
    jp, tp, spec = _net(seed=2)
    xs = _frames(3)
    want = jstream.fft_stream_pair(jnp.asarray(xs), jp, spec.scales, 1,
                                   iters=5)
    got = tstream.stream_bursts_pair(torch.from_numpy(xs), tp, spec.scales,
                                     1, iters=5)
    assert_stream(got, want)


def test_stream_bursts_sweep_matches_jax():
    jp, tp, spec = _net(seed=5)
    xs = _frames(6)
    want = jstream.fft_stream_sweep(jnp.asarray(xs), jp, spec.scales,
                                    iters=4)
    got = tstream.stream_bursts_sweep(torch.from_numpy(xs), tp, spec.scales,
                                      iters=4)
    assert tuple(got.mses.shape) == (3, spec.n_pairs, 5)
    np.testing.assert_allclose(got.mses.numpy(), np.asarray(want.mses),
                               rtol=MSE_RTOL)
    for gs, ws in zip(got.params.stages, want.params.stages):
        assert rel(gs.c, ws.c) < W_TOL
        assert rel(gs.b, ws.b) < W_TOL
    for gm, wm in zip(got.moms, want.moms):
        for g, w in zip(gm, wm):
            assert rel(g, w) < W_TOL


def test_stream_bursts_with_axis_name_matches_jax(world):
    """The data-parallel stream (``axis_name``: each frame's lag tensors
    pmean-ed over the axis, here of one rank) against JAX's batched
    stream; the gloo meshes of two and four ranks are in
    tests/test_torch_dist.py."""
    xs, c, f, bb, p = stream_problem(b=2, seed=9)
    j, t = both((xs, c, f, bb, p))
    want = jstream.fft_stream(*j, iters=6)
    got = tstream.stream_bursts(*t, iters=6, axis_name=world)
    assert_stream(got, want)
