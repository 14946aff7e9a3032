"""The port's ω-space bursts and diversity loss against the JAX package (CPU).

- ``fft_burst`` (both transform implementations) and ``fft_burst_dp``
  (the ω-space body and the correlation-space one) against JAX's, from the
  same numpy frames and weights (non-zero biases).
- ``losses.diversity_gradients`` against JAX's, and against autograd of
  ``diversity_loss``.
- ``fft_burst_dp(expout=None)`` trains against the input on either body.

Tolerances: weights and momentum 1e-5 norm-relative, ``mses`` 1e-4
relative per entry — float32 FFTs and DFT products through two libraries,
reaching the weights through the normalised inertia update (measured when
this file was written: at most 3e-7 and 2e-6).  The diversity gradients:
1e-6 norm-relative (the same float32 arithmetic in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spectralae.losses import losses as jloss
from spectralae.train import fft as jfft
from spectralae.train import fft_dp as jdp
from spectralae.train.fft_corr import _true_forward as jforward
from spectralae_torch.losses import losses as tloss
from spectralae_torch.train import fft as tfft
from spectralae_torch.train import fft_dp as tdp

torch.set_num_threads(1)

W_TOL = 1e-5
MSE_RTOL = 1e-4


def rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def problem(seed=0, b=None, d=3, m=4, n=16, ny=None, nk=3):
    """Frames, the anchor output (the JAX forward of other weights) and
    weights with non-zero biases, as numpy."""
    rng = np.random.default_rng(seed)
    ny = n if ny is None else ny
    shape = (b if b else 1, d, n, ny)
    x = (rng.normal(size=shape) * 50).astype(np.float32)
    c = (rng.normal(size=(m, d, nk, nk)) * 0.3).astype(np.float32)
    f = (rng.normal(size=(d, m, nk, nk)) * 0.3).astype(np.float32)
    bb = (rng.normal(size=m) * 0.5).astype(np.float32)
    p = (rng.normal(size=d) * 0.5).astype(np.float32)
    out0 = np.asarray(jforward(jnp.asarray(x), jnp.asarray(c * 0.9),
                               jnp.asarray(f), jnp.asarray(bb),
                               jnp.asarray(p), True))
    if not b:
        x, out0 = x[0], out0[0]
    return x, out0, c, f, bb, p


def both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def assert_result(got, want):
    for name in ("c", "f", "b", "p"):
        assert rel(getattr(got, name), getattr(want, name)) < W_TOL, name
    for i, (g, w) in enumerate(zip(got.mom, want.mom)):
        assert rel(g, w) < W_TOL, f"mom[{i}]"
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=MSE_RTOL)


@pytest.mark.parametrize("impl", ["dft", "fft"])
@pytest.mark.parametrize("kw", [dict(), dict(maxdiff=True),
                                dict(scale_by_dm=False),
                                dict(n=20, ny=12, nk=5)],
                         ids=["basic", "maxdiff", "no_dm", "nonsquare5x5"])
def test_fft_burst_matches_jax(impl, kw):
    kw = dict(kw)
    shape = {k: kw.pop(k) for k in ("n", "ny", "nk") if k in kw}
    x, out0, c, f, bb, p = problem(seed=len(kw) + 3 * len(shape), **shape)
    j, t = both((x, out0, c, f, bb, p))
    want = jfft.fft_burst(j[0], j[0], j[1], *j[2:], lr=0.2, iters=6,
                          impl=impl, **kw)
    got = tfft.fft_burst(t[0], t[0], t[1], *t[2:], lr=0.2, iters=6,
                         impl=impl, **kw)
    assert_result(got, want)


def test_fft_burst_momentum_carry_matches_jax():
    x, out0, c, f, bb, p = problem(seed=9)
    j, t = both((x, out0, c, f, bb, p))
    j1 = jfft.fft_burst(j[0], j[0], j[1], *j[2:], iters=3)
    t1 = tfft.fft_burst(t[0], t[0], t[1], *t[2:], iters=3)
    want = jfft.fft_burst(j[0], j[0], j[1], j1.c, j1.f, j1.b, j1.p,
                          mom=j1.mom, iters=3)
    got = tfft.fft_burst(t[0], t[0], t[1], t1.c, t1.f, t1.b, t1.p,
                         mom=t1.mom, iters=3)
    assert_result(got, want)


@pytest.mark.parametrize("use_pallas,kw", [
    (False, dict()), (False, dict(maxdiff=True)), (True, dict()),
    (True, dict(reanchor_every=3)), (None, dict())],
    ids=["omega", "omega_maxdiff", "corr", "corr_reanchor", "auto_cpu"])
def test_fft_burst_dp_matches_jax(use_pallas, kw):
    """``use_pallas`` False/None runs the ω-space body on CPU tensors in
    both packages, True the correlation-space burst."""
    x, out0, c, f, bb, p = problem(seed=13, b=3)
    j, t = both((x, out0, c, f, bb, p))
    jp = False if use_pallas is None else use_pallas
    want = jdp.fft_burst_dp(j[0], j[0], j[1], *j[2:], lr=0.2, iters=7,
                            use_pallas=jp, **kw)
    got = tdp.fft_burst_dp(t[0], t[0], t[1], *t[2:], lr=0.2, iters=7,
                           use_pallas=use_pallas, **kw)
    assert_result(got, want)


def test_fft_burst_dp_at_batch_one_is_fft_burst():
    x, out0, c, f, bb, p = problem(seed=4, b=1)
    t = both((x, out0, c, f, bb, p))[1]
    got = tdp.fft_burst_dp(t[0], t[0], t[1], *t[2:], iters=5,
                           use_pallas=False)
    want = tfft.fft_burst(t[0][0], t[0][0], t[1][0], *t[2:], iters=5)
    assert_result(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fft_burst_dp_expout_none_trains_against_the_input(use_pallas):
    x, out0, c, f, bb, p = problem(seed=6, b=2)
    t = both((x, out0, c, f, bb, p))[1]
    got = tdp.fft_burst_dp(t[0], None, t[1], *t[2:], iters=4,
                           use_pallas=use_pallas)
    want = tdp.fft_burst_dp(t[0], t[0], t[1], *t[2:], iters=4,
                            use_pallas=use_pallas)
    for name in ("c", "f", "b", "p", "mses"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_gradient_k_io_matches_jax():
    rng = np.random.default_rng(2)
    d, m, n = 3, 4, 16
    nyr = n // 2 + 1

    def cplx(*s):
        return (rng.normal(size=s) + 1j * rng.normal(size=s)
                ).astype(np.complex64)
    arrays = (cplx(d, n, nyr), cplx(d, n, nyr), cplx(d, n, nyr),
              cplx(m, d, n, nyr), cplx(d, m, n, nyr),
              rng.normal(size=m).astype(np.float32))
    j, t = both(arrays)
    for g, w in zip(tfft.gradient_k_io(*t, n, n),
                    jfft.gradient_k_io(*j, n, n)):
        assert rel(g, w) < 1e-6


@pytest.mark.parametrize("m,d", [(4, 3), (3, 2), (10, 3)])
def test_diversity_gradients_match_jax(m, d):
    rng = np.random.default_rng(m * 10 + d)
    arrays = (rng.normal(size=(m, d, 5, 5)).astype(np.float32),
              rng.normal(size=(d, m, 5, 5)).astype(np.float32),
              rng.normal(size=m).astype(np.float32),
              rng.normal(size=d).astype(np.float32))
    j, t = both(arrays)
    for g, w in zip(tloss.diversity_gradients(*t),
                    jloss.diversity_gradients(*j)):
        assert g.shape == w.shape
        assert rel(g, w) < 1e-6


def test_diversity_loss_matches_jax_and_its_gradient():
    """The scalar form equals JAX's; its autograd gradient in the kernels
    is the explicit repulsion gradient (test_gradients.py)."""
    rng = np.random.default_rng(5)
    c = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    want = float(jloss.diversity_loss(jnp.asarray(c), jnp.asarray(b)))
    ct = torch.tensor(c, requires_grad=True)
    loss = tloss.diversity_loss(ct, torch.from_numpy(b))
    assert abs(float(loss.detach()) - want) <= 1e-5 * abs(want)
    loss.backward()
    jgrad = jax.grad(jloss.diversity_loss)(jnp.asarray(c), jnp.asarray(b))
    assert rel(ct.grad, jgrad) < 1e-5
    cd = tloss.diversity_gradients(torch.from_numpy(c),
                                   torch.zeros(3, 4, 3, 3),
                                   torch.from_numpy(b), torch.zeros(3))[0]
    assert rel(ct.grad, cd) < 1e-5


def test_mse_helpers_match_jax():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(2, 3, 8, 6)).astype(np.float32)
    b = rng.normal(size=(2, 3, 8, 6)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert rel(tloss.mse_raw(ta, tb), jloss.mse_raw(a, b)) < 1e-6
    assert rel(tloss.mse_coord(ta, tb, 4, 5, 5),
               jloss.mse_coord(a, b, 4, 5, 5)) < 1e-6
    assert np.array_equal(tloss._pair_mask(4, 3).numpy(),
                          np.asarray(jloss._pair_mask(4, 3)))
