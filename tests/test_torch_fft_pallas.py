"""The port's omega-space burst engines against the JAX package (CPU).

Mirrors every case of tests/test_fft_pallas.py: the same numpy frames and
weights (non-zero biases) go through the JAX engines, whose Pallas kernels
run in interpret mode as the JAX package's own tests run them, and through
the port's, whose kernel wrappers run their plain versions on CPU tensors.
Then each plain kernel against the JAX package's jnp formulas, and
``auto_burst``'s routing.

Tolerances: weights and momentum 1e-5 norm-relative, ``mses`` 1e-4
relative per entry, at <= 10 iterations — float32 FFTs and basis products
through two libraries, reaching the weights through the normalised inertia
update (the largest measured when this file was written: 2.9e-7 on the
weights and momenta, 6.0e-7 on the MSEs).  The bf16 operands
(``mxu_dtype``): 1e-3 norm-relative on the weights and 1e-3 on the MSEs
against JAX's bf16 engine (measured: at most 8.1e-5 and 3.6e-6; both
round the same operands, and a sum that straddles a rounding boundary in
one package moves that operand by 2^-9), and the JAX test's own 5 % band
against float32.  The plain kernels against the jnp formulas:
1e-5 norm-relative (the same products in another association).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spectralae.ops import dft as jdft
from spectralae.ops import spectral as jspec
from spectralae.train import fft as jfft
from spectralae.train import fft_dp as jdp
from spectralae.train import fft_iter as jiter
from spectralae.train import fft_pallas as jpal
from spectralae.train.fft_corr import _true_forward as jforward
from spectralae_torch import _kernels
from spectralae_torch.ops import burst_kernels as bk
from spectralae_torch.train import fft as tfft
from spectralae_torch.train import fft_dp as tdp
from spectralae_torch.train import fft_iter as titer
from spectralae_torch.train import fft_pallas as tpal
from torch_dist_worker import world  # noqa: F401 (a fixture)

torch.set_num_threads(1)

W_TOL = 1e-5
MSE_RTOL = 1e-4
BF16_TOL = 1e-3
KERNEL_TOL = 1e-5


def rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def problem(seed=0, b=None, d=2, m=4, n=16, nk=3):
    """Frames, the output of other weights (the JAX forward) and weights
    with non-zero biases, as numpy (the JAX test's setup: D=2, M=4, 3x3,
    pixel-scale frames x 50)."""
    rng = np.random.default_rng(seed)
    shape = (b if b else 1, d, n, n)
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


def assert_result(got, want, w_tol=W_TOL, mse_tol=MSE_RTOL, mom=True):
    for name in ("c", "f", "b", "p"):
        assert rel(getattr(got, name), getattr(want, name)) < w_tol, name
    if mom:
        for i, (g, w) in enumerate(zip(got.mom, want.mom)):
            assert rel(g, w) < w_tol, f"mom[{i}]"
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=mse_tol)


def run_both(jfn, tfn, arrays, bf16=False, **kw):
    """The JAX engine (interpret mode) and the port's on the same arrays,
    trained against the input, with bf16 operands when ``bf16``; the port
    must launch no kernel here."""
    j, t = both(arrays)
    want = jfn(j[0], j[0], j[1], *j[2:], interpret=True,
               **(dict(kw, mxu_dtype=jnp.bfloat16) if bf16 else kw))
    if bf16:
        kw["mxu_dtype"] = torch.bfloat16
    before = _kernels.LAUNCHES.copy()
    got = tfn(t[0], t[0], t[1], *t[2:], **kw)
    assert _kernels.LAUNCHES == before
    return got, want


# ------------------------------------------- test_fft_pallas.py's cases

@pytest.mark.parametrize("iters", [1, 5])
def test_pallas_burst_matches_jax(iters):
    arrays = problem()
    got, want = run_both(jpal.fft_burst_pallas, tpal.fft_burst_pallas,
                         arrays, lr=0.2, iters=iters)
    assert_result(got, want)
    j = both(arrays)[0]
    assert_result(got, jfft.fft_burst(j[0], j[0], j[1], *j[2:], lr=0.2,
                                      iters=iters, impl="dft"))


def test_pallas_burst_converges():
    x, out0, c, f, bb, p = problem(seed=1)
    t = both((x, out0, c, f, bb, p))[1]
    res = tpal.fft_burst_pallas(t[0], t[0], t[1], *t[2:], lr=0.2, iters=60)
    mses = res.mses.numpy()
    assert np.all(np.isfinite(mses))
    assert mses[-1] < mses[0] * 0.9


def test_pallas_burst_nonsquare_tiles():
    """W = 32·17 = 544 bins: the kernels' masked tail (the JAX test's
    padded tile), here through the plain versions."""
    got, want = run_both(jpal.fft_burst_pallas, tpal.fft_burst_pallas,
                         problem(seed=2, n=32, m=3), lr=0.2, iters=3)
    assert_result(got, want)


def test_pallas_burst_maxdiff_matches_jax():
    got, want = run_both(jpal.fft_burst_pallas, tpal.fft_burst_pallas,
                         problem(seed=3), lr=0.2, iters=4, maxdiff=True)
    assert_result(got, want)


def test_pallas_burst_momentum_carry():
    x, out0, c, f, bb, p = problem(seed=4)
    j, t = both((x, out0, c, f, bb, p))
    j1 = jpal.fft_burst_pallas(j[0], j[0], j[1], *j[2:], lr=0.2, iters=3,
                               interpret=True)
    t1 = tpal.fft_burst_pallas(t[0], t[0], t[1], *t[2:], lr=0.2, iters=3)
    want = jpal.fft_burst_pallas(j[0], j[0], j[1], j1.c, j1.f, j1.b, j1.p,
                                 mom=j1.mom, lr=0.2, iters=3, interpret=True)
    got = tpal.fft_burst_pallas(t[0], t[0], t[1], t1.c, t1.f, t1.b, t1.p,
                                mom=t1.mom, lr=0.2, iters=3)
    assert_result(got, want)


def test_pallas_burst_batched_matches_dp():
    arrays = problem(seed=5, b=4)
    got, want = run_both(jpal.fft_burst_pallas, tpal.fft_burst_pallas,
                         arrays, lr=0.2, iters=5)
    assert_result(got, want)
    j, t = both(arrays)
    assert_result(got, jdp.fft_burst_dp(j[0], j[0], j[1], *j[2:], lr=0.2,
                                        iters=5, use_pallas=False))
    assert_result(got, tdp.fft_burst_dp(t[0], t[0], t[1], *t[2:], lr=0.2,
                                        iters=5, use_pallas=False))


def test_bf16_mxu_burst_close_to_f32():
    arrays = problem(seed=6)
    got, want = run_both(jpal.fft_burst_pallas, tpal.fft_burst_pallas,
                         arrays, lr=0.2, iters=10)
    t = both(arrays)[1]
    bf16 = tpal.fft_burst_pallas(t[0], t[0], t[1], *t[2:], lr=0.2, iters=10,
                                 mxu_dtype=torch.bfloat16)
    assert bf16.c.dtype == torch.float32
    np.testing.assert_allclose(bf16.mses.numpy(), got.mses.numpy(),
                               rtol=0.05)
    j = both(arrays)[0]
    jb = jpal.fft_burst_pallas(j[0], j[0], j[1], *j[2:], lr=0.2, iters=10,
                               interpret=True, mxu_dtype=jnp.bfloat16)
    assert_result(bf16, jb, BF16_TOL, BF16_TOL)


def test_fused_step_burst_matches_two_kernel():
    arrays = problem(seed=7)
    got, want = run_both(jpal.fft_burst_pallas_fused,
                         tpal.fft_burst_pallas_fused, arrays, lr=0.2, iters=6)
    assert_result(got, want)
    t = both(arrays)[1]
    assert_result(got, tpal.fft_burst_pallas(t[0], t[0], t[1], *t[2:],
                                             lr=0.2, iters=6))


def test_fused_step_burst_maxdiff():
    got, want = run_both(jpal.fft_burst_pallas_fused,
                         tpal.fft_burst_pallas_fused, problem(seed=8),
                         lr=0.2, iters=4, maxdiff=True)
    assert_result(got, want)


def test_itergrid_burst_matches_jax():
    arrays = problem(seed=9)
    got, want = run_both(jiter.fft_burst_itergrid, titer.fft_burst_itergrid,
                         arrays, lr=0.2, iters=5)
    assert_result(got, want)
    j = both(arrays)[0]
    assert_result(got, jfft.fft_burst(j[0], j[0], j[1], *j[2:], lr=0.2,
                                      iters=5, impl="dft"))


def test_itergrid_burst_momentum_and_nonaligned():
    """W = 544 (the masked tail), a momentum carry into a second burst."""
    x, out0, c, f, bb, p = problem(seed=10, n=32, m=3)
    j, t = both((x, out0, c, f, bb, p))
    j1 = jiter.fft_burst_itergrid(j[0], j[0], j[1], *j[2:], lr=0.2, iters=3,
                                  interpret=True)
    t1 = titer.fft_burst_itergrid(t[0], t[0], t[1], *t[2:], lr=0.2, iters=3)
    want = jiter.fft_burst_itergrid(j[0], j[0], j[1], j1.c, j1.f, j1.b, j1.p,
                                    mom=j1.mom, lr=0.2, iters=2,
                                    interpret=True)
    got = titer.fft_burst_itergrid(t[0], t[0], t[1], t1.c, t1.f, t1.b, t1.p,
                                   mom=t1.mom, lr=0.2, iters=2)
    assert_result(got, want)
    a1 = tfft.fft_burst(t[0], t[0], t[1], *t[2:], lr=0.2, iters=3)
    a2 = tfft.fft_burst(t[0], t[0], t[1], a1.c, a1.f, a1.b, a1.p, mom=a1.mom,
                        lr=0.2, iters=2)
    assert_result(got, a2)


def test_fft_and_dft_impls_agree():
    """The literal pad+rfft2 path and the DFT-product path, in the port,
    and the port's ω-space engine beside them."""
    arrays = problem(seed=11)
    t = both(arrays)[1]
    a = tfft.fft_burst(t[0], t[0], t[1], *t[2:], lr=0.2, iters=4,
                       impl="fft")
    b = tfft.fft_burst(t[0], t[0], t[1], *t[2:], lr=0.2, iters=4,
                       impl="dft")
    assert_result(a, b)
    assert_result(tpal.fft_burst_pallas(t[0], t[0], t[1], *t[2:], lr=0.2,
                                        iters=4), b)


# ------------------------------------------------ more of the engines

@pytest.mark.parametrize("engine", ["body", "fused", "itergrid"])
def test_engines_default_net_shape_and_bf16(engine):
    """The default net's pair 0 (D=3, M=10, 5x5) in both operand types."""
    fns = {"body": (jpal.fft_burst_pallas, tpal.fft_burst_pallas),
           "fused": (jpal.fft_burst_pallas_fused,
                     tpal.fft_burst_pallas_fused),
           "itergrid": (jiter.fft_burst_itergrid, titer.fft_burst_itergrid)}
    arrays = problem(seed=12, b=2, d=3, m=10, n=20, nk=5)
    got, want = run_both(*fns[engine], arrays, lr=0.2, iters=4)
    assert_result(got, want)
    got, want = run_both(*fns[engine], arrays, bf16=True, lr=0.2, iters=4)
    assert_result(got, want, BF16_TOL, BF16_TOL)


def test_scale_by_dm_false_matches_jax():
    got, want = run_both(jpal.fft_burst_pallas_fused,
                         tpal.fft_burst_pallas_fused, problem(seed=13),
                         lr=0.2, iters=4, scale_by_dm=False)
    assert_result(got, want)


@pytest.mark.parametrize("engine", ["fft_burst_pallas",
                                    "fft_burst_pallas_fused"])
def test_engines_with_axis_name_match_jax(world, engine):
    """The data-parallel engines (``axis_name``: each iteration's
    gradients pmean-ed between the launches, here over one rank) against
    the JAX engines; the gloo meshes of two and four ranks are in
    tests/test_torch_dist.py."""
    j, t = both(problem(seed=16, b=2))
    want = getattr(jpal, engine)(j[0], j[0], j[1], *j[2:], lr=0.2, iters=4,
                                 interpret=True)
    got = getattr(tpal, engine)(t[0], t[0], t[1], *t[2:], lr=0.2, iters=4,
                                axis_name=world)
    assert_result(got, want)


def test_engine_options_are_checked():
    t = both(problem(seed=14))[1]
    with pytest.raises(TypeError, match="ProcessGroup"):
        tpal.fft_burst_pallas(t[0], t[0], t[1], *t[2:], iters=1,
                              axis_name="data")
    with pytest.raises(TypeError, match="mxu_dtype"):
        titer.fft_burst_itergrid(t[0], t[0], t[1], *t[2:], iters=1,
                                 mxu_dtype=torch.float16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        bk.grad_project(*(a.to("meta") for a in _kernel_inputs(15)[:5]),
                        norm=1.0, scale=1.0)


# ------------------------------------ the plain kernels vs jnp formulas

def _kernel_inputs(seed, d=3, m=10, n=24, nk=5):
    """planes, basis, wv, cf, b, p and consts of one frame, and the numpy
    spectra and weights they came from."""
    x, out0, c, f, bb, p = problem(seed=seed, d=d, m=m, n=n, nk=nk)
    t = both((x, out0, c, f, bb, p))[1]
    s = tpal._prepare(t[0], t[0], t[1], t[2], True, torch.float32)
    cf = tpal._stack(t[2], t[3], m * d, nk * nk)
    return s.planes, s.basis, s.wv, cf, t[4], t[5], s, (x, out0, c, f, bb, p)


def _jax_spectra(arrays):
    x, out0, c, f, bb, p = (jnp.asarray(a) for a in arrays)
    n = x.shape[-1]
    return (jspec.rfft2(x), jspec.rfft2(out0), jdft.kernel_spectrum(c, n, n),
            jdft.kernel_spectrum(f, n, n), c, f, bb, p, n)


def test_grad_project_plain_is_gradient_k_io_and_project():
    planes, basis, wv, cf, b, p, s, arrays = _kernel_inputs(20)
    X, O, Cf, Ff, c, f, bb, pp, n = _jax_spectra(arrays)
    dc, df, db, dp = jfft.gradient_k_io(X, X, O, Cf, Ff, bb, n, n)
    nk = c.shape[-1]
    g, gb, gp = bk.grad_project(planes, basis, wv, cf, b,
                                norm=s.consts["norm"], scale=s.consts["scale"])
    md = c.shape[0] * c.shape[1]
    assert rel(g[:md].reshape(c.shape), jdft.kernel_project(dc, nk, nk, n, n)
               ) < KERNEL_TOL
    assert rel(g[md:].reshape(f.shape), jdft.kernel_project(df, nk, nk, n, n)
               ) < KERNEL_TOL
    assert rel(gb, db) < KERNEL_TOL and rel(gp, dp) < KERNEL_TOL


def _two_stage(arrays):
    X, O, Cf, Ff, c, f, bb, pp, n = _jax_spectra(arrays)
    On, _, _ = jfft._two_stage_output(X, c, f, bb, pp, n, n, impl="dft")
    mse = jspec.parseval_mse(X, On, c.shape[1], c.shape[0], n, n)
    return X, On, Cf, Ff, c, f, bb, mse, n


def _planes_of(O, n):
    return np.stack([np.asarray(O.real).reshape(O.shape[0], -1),
                     np.asarray(O.imag).reshape(O.shape[0], -1)])


def test_respectra_plain_is_two_stage_output_and_parseval():
    planes, basis, wv, cf, b, p, s, arrays = _kernel_inputs(21)
    X, On, Cf, Ff, c, f, bb, mse, n = _two_stage(arrays)
    O, msep = bk.respectra_conv(planes, basis, wv, cf, b, p,
                                norm=s.consts["norm"],
                                inv_m=s.consts["inv_m"],
                                inv_d=s.consts["inv_d"])
    assert rel(O, _planes_of(On, n)) < KERNEL_TOL
    assert rel(tpal._mse_of(msep, c, n, n), mse) < KERNEL_TOL


def test_fused_step_plain_is_the_forward_then_the_gradients():
    planes, basis, wv, cf, b, p, s, arrays = _kernel_inputs(22)
    X, On, Cf, Ff, c, f, bb, mse, n = _two_stage(arrays)
    O, msep, g, gb, gp = bk.fused_step(planes, basis, wv, cf, b, p,
                                       **s.consts)
    assert rel(O, _planes_of(On, n)) < KERNEL_TOL
    assert rel(tpal._mse_of(msep, c, n, n), mse) < KERNEL_TOL
    dc, df, db, dp = jfft.gradient_k_io(X, X, On, Cf, Ff, bb, n, n)
    nk, md = c.shape[-1], c.shape[0] * c.shape[1]
    assert rel(g[:md].reshape(c.shape), jdft.kernel_project(dc, nk, nk, n, n)
               ) < KERNEL_TOL
    assert rel(g[md:].reshape(f.shape), jdft.kernel_project(df, nk, nk, n, n)
               ) < KERNEL_TOL
    assert rel(gb, db) < KERNEL_TOL and rel(gp, dp) < KERNEL_TOL


def test_itergrid_plain_is_the_iteration_loop():
    """K8's plain version: iteration 0's MSE is O₀'s, and ``iters`` updates
    are those of the fused engine."""
    planes, basis, wv, cf, b, p, s, arrays = _kernel_inputs(23, d=2, m=4)
    zeros = [torch.zeros_like(t) for t in (cf, b, p)]
    out = bk.itergrid(planes, basis, wv, cf, b, p, *zeros, iters=3,
                      lr_eff=0.02, alpha=0.9, **s.consts)
    x, out0, c, f, bb, pp = arrays
    t = both(arrays)[1]
    ref = tpal.fft_burst_pallas_fused(t[0], t[0], t[1], *t[2:], lr=0.2,
                                      iters=3)
    md = c.shape[0] * c.shape[1]
    assert rel(out[0][:md].reshape(c.shape), ref.c) < W_TOL
    assert rel(out[1], ref.b) < W_TOL
    assert rel(tpal._mse_of(out[-1], t[2], s.nx, s.ny), ref.mses) < MSE_RTOL


def test_basis_and_weights_equal_jax():
    """The [2, P, W] basis is the JAX package's, unpadded; wv its weights."""
    basis = tpal._basis(5, 5, 24, 20, torch.device("cpu"))
    cos, sin = jpal._basis(5, 5, 24, 20, 24 * 11)
    assert np.array_equal(basis[0].numpy(), cos)
    assert np.array_equal(basis[1].numpy(), sin)
    wv = jpal._herm_weights(24, 20, 24 * 11 + 8)
    assert np.array_equal(tpal._herm_weights(24, 20, torch.device("cpu"))
                          .numpy(), wv[0, :24 * 11])
    assert not wv[0, 24 * 11:].any()


# ------------------------------------------------------------ routing

@pytest.mark.parametrize("expout", ["x", None])
def test_auto_burst_routes_cpu_to_the_omega_burst(expout):
    """On CPU tensors ``auto_burst`` is the plain ω-space burst, as JAX's
    is off a TPU; ``expout=None`` trains against the input."""
    arrays = problem(seed=16)
    j, t = both(arrays)
    got = tpal.auto_burst(t[0], t[0] if expout else None, t[1], *t[2:],
                          lr=0.2, iters=5)
    want = jpal.auto_burst(j[0], j[0] if expout else None, j[1], *j[2:],
                           lr=0.2, iters=5)
    assert_result(got, want)
    same = tfft.fft_burst(t[0], t[0], t[1], *t[2:], lr=0.2, iters=5)
    for name in ("c", "f", "b", "p", "mses"):
        assert torch.equal(getattr(got, name), getattr(same, name)), name


def test_auto_burst_routes_cuda_to_the_corr_burst(monkeypatch):
    """A CUDA tensor goes to the correlation-space burst, re-anchored every
    100 iterations beyond 100 (the routing alone, with the corr burst
    replaced by a recorder)."""
    from spectralae_torch.train import fft_corr

    class Cuda:
        is_cuda = True
    seen = []
    monkeypatch.setattr(fft_corr, "fft_burst_corr",
                        lambda *a, **kw: seen.append(kw) or "corr")
    for iters, anchor in ((100, None), (250, 100)):
        assert tpal.auto_burst(Cuda(), None, None, 1, 2, 3, 4,
                               iters=iters) == "corr"
        assert seen[-1]["reanchor_every"] == anchor
