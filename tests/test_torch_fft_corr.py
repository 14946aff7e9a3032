"""The port's correlation-space burst against the JAX package (CPU).

The same numpy inputs and weights (non-zero biases, so an off-by-one in the
bias-as-tap channel cannot hide) go through JAX's ``corr_precompute``,
``corr_precompute_fused`` and ``burst_corr`` and through the port's.  The
JAX Pallas window kernel runs in interpret mode; the port's K4 wrapper runs
its plain version on CPU tensors.

Tolerances, each with its reason:

- T dicts: 1e-5 norm-relative per entry — two FFT libraries (pocketfft
  under both, but through different wrappers and sum orders) feed windows
  that sum nx·nyr products.
- burst results: weights and momentum 1e-5 norm-relative; ``mses`` 1e-4
  relative per entry — the inertia update normalises each gradient entry,
  so the FFTs' ~1e-7 rounding reaches the weights only through entries
  under GRAD_CLIP, while the MSE trajectory is a difference of energies.
  Measured when this file was written: at most 3.8e-7 (momentum) and
  1.1e-6 (mses).
- against the port's own ω-space ``fft_burst`` (the oracle): the JAX
  package's own corr-vs-jnp tolerance, rtol 1e-3 / atol 1e-4 — the two
  algorithms round differently (test_fft_corr.py::test_corr_burst_matches_jnp).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spectralae.train import fft_corr as jcorr
from spectralae_torch.train import fft_corr as tcorr
from spectralae_torch.train.fft import fft_burst
from torch_dist_worker import world  # noqa: F401 (a fixture)

torch.set_num_threads(1)

T_TOL = 1e-5
W_TOL = 1e-5
MSE_RTOL = 1e-4


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def problem(seed=0, b=None, d=3, m=4, n=16, ny=None, nk=3, scale=50.0):
    """Frames, weights with non-zero biases, and the momentum of a carry,
    as numpy."""
    rng = np.random.default_rng(seed)
    ny = n if ny is None else ny
    shape = (d, n, ny) if b is None else (b, d, n, ny)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    c = (rng.normal(size=(m, d, nk, nk)) * 0.3).astype(np.float32)
    f = (rng.normal(size=(d, m, nk, nk)) * 0.3).astype(np.float32)
    bb = (rng.normal(size=m) * 0.5).astype(np.float32)
    p = (rng.normal(size=d) * 0.5).astype(np.float32)
    mom = tuple((rng.normal(size=t.shape) * 1e-3).astype(np.float32)
                for t in (c, f, bb, p))
    return x, c, f, bb, p, mom


def both(*arrays):
    """Each numpy array as a JAX array and as a CPU tensor."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def jax_forward(x, c, f, b, p, scale_by_dm=True):
    return np.asarray(jcorr._true_forward(jnp.asarray(x), jnp.asarray(c),
                                          jnp.asarray(f), jnp.asarray(b),
                                          jnp.asarray(p), scale_by_dm))


def assert_result(got, want, mse_rtol=MSE_RTOL, w_tol=W_TOL):
    for name in ("c", "f", "b", "p"):
        assert rel(getattr(got, name), getattr(want, name)) < w_tol, name
    for i, (g, w) in enumerate(zip(got.mom, want.mom)):
        assert rel(g, w) < w_tol, f"mom[{i}]"
    assert got.mses.shape == want.mses.shape
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=mse_rtol)


# ------------------------------------------------------------ precompute

@pytest.mark.parametrize("n,ny,nk,b", [(16, 16, 3, 2), (20, 12, 5, 1)])
def test_corr_precompute_matches_jax(n, ny, nk, b):
    x, c, f, bb, p, _ = problem(seed=n, b=b, n=n, ny=ny, nk=nk)
    out0 = jax_forward(x, c * 1.1, f, bb, p)          # a foreign anchor
    (jx, jo, jc, jf), (tx, to, tc, tf) = both(x, out0, c, f)
    want = jcorr.corr_precompute(jx, jx, jo, jc, jf)
    got = tcorr.corr_precompute(tx, tx, to, tc, tf)
    assert set(got) == set(want)
    for k in want:
        assert rel(got[k], want[k]) < T_TOL, k


@pytest.mark.parametrize("route", [None, True, False, "bf16"])
@pytest.mark.parametrize("n,ny,nk,b", [(16, 16, 3, 2), (20, 12, 5, 1)])
def test_corr_precompute_fused_matches_jax(route, n, ny, nk, b):
    """Every window route: JAX's Pallas kernel (interpret) or XLA branch
    against the port's K4 wrapper (plain on the CPU) or plain version."""
    x, c, f, bb, p, _ = problem(seed=n + 1, b=b, n=n, ny=ny, nk=nk)
    j, t = both(x, c, f, bb, p)
    # the JAX package takes its Pallas kernel only on a TPU by default;
    # None is compared with its kernel route, as the port's None is K4's
    jroute = True if route is None else route
    want = jcorr.corr_precompute_fused(*j, pallas_windows=jroute)
    got = tcorr.corr_precompute_fused(*t, pallas_windows=route)
    for k in want:
        assert rel(got[k], want[k]) < T_TOL, k


def test_fused_precompute_equals_unfused_on_the_true_forward():
    """With out0 the model's own forward, the fused T dict equals the
    explicit one (test_fft_corr.py::test_fused_precompute_matches_unfused)."""
    x, c, f, bb, p, _ = problem(seed=3, b=2)
    t = both(x, c, f, bb, p)[1]
    out0 = tcorr._true_forward(t[0], *t[1:], True)
    fused = tcorr.corr_precompute_fused(*t)
    unfused = tcorr.corr_precompute(t[0], t[0], out0, t[1], t[2])
    for k in fused:
        assert rel(fused[k], unfused[k]) < 1e-4, k


@pytest.mark.parametrize("what", ["precompute", "burst"])
def test_pixel_route_matches_jax(what):
    """``pallas_windows="pixel"`` (ops/pixel_corr.py, no FFT) against the
    JAX package's pixel route: the T dict, and a burst through it."""
    x, c, f, bb, p, _ = problem(seed=21, b=2)
    j, t = both(x, c, f, bb, p)
    if what == "precompute":
        want = jcorr.corr_precompute_fused(*j, pallas_windows="pixel")
        got = tcorr.corr_precompute_fused(*t, pallas_windows="pixel")
        assert set(got) == set(want)
        for k in want:
            assert rel(got[k], want[k]) < T_TOL, k
    else:
        kw = dict(lr=0.2, iters=6, pallas_windows="pixel")
        assert_result(tcorr.burst_corr(t[0], None, None, *t[1:], **kw),
                      jcorr.burst_corr(j[0], None, None, *j[1:], **kw))


@pytest.mark.parametrize("n,nk,d,m,b", [
    (8, 5, 2, 3, 1),        # lag window wider than the grid (aliasing)
    (32, 3, 3, 4, 2),       # batched
    (16, 3, 2, 4, None),
])
def test_pixel_precompute_matches_spectral(n, nk, d, m, b):
    """The pixel route's T dict equals the spectral route's — windows,
    energies, DC scalars, the mod-N lag aliasing of a window wider than
    the grid (the JAX package's test_pixel_precompute_matches_spectral and
    its tolerances)."""
    x, c, f, bb, p, _ = problem(seed=n + nk, b=b, d=d, m=m, n=n, nk=nk)
    t = both(x if b else x[None], c, f, bb, p)[1]
    Ts = tcorr.corr_precompute_fused(*t, pallas_windows=False)
    Tp = tcorr.corr_precompute_fused(*t, pallas_windows="pixel")
    assert set(Ts) == set(Tp)
    lag_scale = max(float(Ts[k].abs().max()) for k in ("XX", "XE0", "XG0"))
    for k in Ts:
        want = Ts[k].numpy()
        atol = (1e-5 * lag_scale if k in ("XX", "XE0", "XG0")
                else 1e-5 * float(np.max(np.abs(want))) + 1e-6)
        np.testing.assert_allclose(Tp[k].numpy(), want, rtol=2e-3,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("batch,maxdiff,reanchor", [
    (None, False, None), (2, False, None), (None, True, None),
    (None, False, 4)])
def test_pixel_burst_matches_spectral(batch, maxdiff, reanchor):
    """Whole fused bursts through the pixel route equal the spectral ones
    (the JAX package's test_pixel_burst_matches_spectral, rtol/atol 2e-4)."""
    x, c, f, bb, p, _ = problem(seed=30, b=batch)
    t = both(x, c, f, bb, p)[1]
    kw = dict(lr=0.2, iters=9, maxdiff=maxdiff, reanchor_every=reanchor)
    ref = tcorr.burst_corr(t[0], None, None, *t[1:], pallas_windows=False,
                           **kw)
    got = tcorr.burst_corr(t[0], None, None, *t[1:], pallas_windows="pixel",
                           **kw)
    for name in ("c", "f", "b", "p", "mses"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name).numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("route", ["pixel", "fft", "fft-bf16"])
def test_routes_without_a_model_sharded_form_refuse_model_axis(route):
    """As in the JAX package (fft_corr.py:414-418), before any collective."""
    x, c, f, bb, p, _ = problem(b=1)
    t = both(x, c, f, bb, p)[1]
    with pytest.raises(ValueError, match="model-sharded"):
        tcorr.corr_precompute_fused(*t, model_axis=object(),
                                    pallas_windows=route)


# ------------------------------------------------ the four-step FFT route

def jax_setup(nx=16, d=2, m=4, lk=1, ll=None, seed=0, b=None):
    """tests/test_fft_corr.py's ``setup``: frames at pixel scale and the
    pair-0 weights of an initialised net, as numpy."""
    import jax
    from spectralae.core.config import Config, LayerParams
    from spectralae.core.types import init_params, initial_spec
    ll = lk if ll is None else ll
    cfg = Config(nx=nx, ny=nx, d=d,
                 layer=LayerParams(depth=m, lk=lk, ll=ll, scale=1, rmax=0.5))
    params = init_params(jax.random.key(seed), initial_spec(cfg), 0.5)
    shape = (d, nx, nx) if b is None else (b, d, nx, nx)
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 50
    enc, dec = params.pair(0)
    return [x] + [np.asarray(a) for a in (enc.c, dec.c, enc.b, dec.b)]


def assert_matches(got, ref, rtol=1e-3, atol=1e-4):
    for name in ("mses", "c", "f", "b", "p"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("nx,lk,ll,d,m,b", [
    (16, 1, 1, 2, 4, None),     # lag window wider than the grid
    (32, 1, 1, 3, 4, 2),        # batched
    (32, 1, 2, 2, 3, None),     # non-square 3x5 kernel
])
def test_fft_route_precompute_matches(nx, lk, ll, d, m, b):
    """pallas_windows='fft' (the four-step rfft2 into K4 in mixed bin
    order) gives the T dict of JAX's 'fft' route and of the port's plain
    route (test_fft_corr.py::test_fft_mode_precompute_matches_spectral,
    with its tolerances)."""
    arrays = jax_setup(nx=nx, d=d, m=m, lk=lk, ll=ll, b=b)
    if b is None:
        arrays[0] = arrays[0][None]
    j, t = both(*arrays)
    got = tcorr.corr_precompute_fused(*t, pallas_windows="fft")
    for ref in (jcorr.corr_precompute_fused(*j, pallas_windows="fft"),
                tcorr.corr_precompute_fused(*t, pallas_windows=False)):
        assert set(got) == set(ref)
        lag_scale = max(float(np.max(np.abs(np.asarray(ref[k]))))
                        for k in ("XX", "XE0", "XG0"))
        for k in ref:
            want = np.asarray(ref[k])
            atol = (1e-5 * lag_scale if k in ("XX", "XE0", "XG0")
                    else 1e-5 * float(np.max(np.abs(want))) + 1e-6)
            np.testing.assert_allclose(np.asarray(got[k]), want, rtol=2e-3,
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("batch,reanchor", [(None, None), (2, 4)])
def test_fft_route_burst_matches(batch, reanchor):
    """Fused bursts through the 'fft' precompute equal the plain route's
    and JAX's 'fft' route (weights, MSE trajectory; 2e-4)."""
    arrays = jax_setup(b=batch)
    j, t = both(*arrays)
    kw = dict(lr=0.2, iters=9, reanchor_every=reanchor)
    got = tcorr.burst_corr(t[0], None, None, *t[1:], pallas_windows="fft",
                           **kw)
    assert_matches(got, tcorr.burst_corr(t[0], None, None, *t[1:],
                                         pallas_windows=False, **kw),
                   rtol=2e-4, atol=2e-4)
    assert_matches(got, jcorr.fft_burst_corr(j[0], None, None, *j[1:],
                                             pallas_windows="fft", **kw),
                   rtol=2e-4, atol=2e-4)


def test_fft_bf16_route_burst_converges_at_pixel_scale():
    """'fft-bf16' (bf16 planes from the FFT) follows the float32 trajectory
    at pixel scale and descends."""
    t = both(*jax_setup(nx=32, d=3, m=4))[1]
    kw = dict(lr=0.2, iters=12)
    ref = tcorr.burst_corr(t[0], None, None, *t[1:], pallas_windows=False,
                           **kw)
    got = tcorr.burst_corr(t[0], None, None, *t[1:],
                           pallas_windows="fft-bf16", **kw)
    m_ref, m_got = ref.mses.numpy(), got.mses.numpy()
    assert m_got[-1] < 0.5 * m_got[0]
    np.testing.assert_allclose(m_got, m_ref, rtol=3e-2)
    np.testing.assert_allclose(got.c.numpy(), ref.c.numpy(), rtol=0,
                               atol=5e-3 * float(ref.c.abs().max()))


@pytest.mark.parametrize("axes,fused,route", [
    ("data", True, None), ("model", True, None), ("model", True, False),
    ("both", False, None)])
def test_parallel_axes_of_one_rank_match_jax(world, axes, fused, route):
    """``burst_corr`` with ``axis_name`` (the tensors pmean-ed over it)
    and ``model_axis`` (the precompute sharded over it: K4's row slab, or
    the plain TP pipeline for ``pallas_windows=False``), each an axis of
    one rank, against the JAX package's burst; the gloo meshes of two and
    four ranks are in tests/test_torch_dist.py."""
    x, c, f, bb, p, _ = problem(seed=23, b=2)
    out0 = None if fused else jax_forward(x, c * 1.1, f, bb, p)
    kw = dict(lr=0.2, iters=6)
    axes_kw = dict(axis_name=world if axes in ("data", "both") else None,
                   model_axis=world if axes in ("model", "both") else None)
    if fused:
        j, t = both(x, c, f, bb, p)
        want = jcorr.burst_corr(j[0], None, None, *j[1:], **kw)
        got = tcorr.burst_corr(t[0], None, None, *t[1:], **kw, **axes_kw,
                               pallas_windows=route)
    else:
        j, t = both(x, out0, c, f, bb, p)
        want = jcorr.burst_corr(j[0], j[0], *j[1:], **kw)
        got = tcorr.burst_corr(t[0], t[0], *t[1:], **kw, **axes_kw)
    assert_result(got, want)


# ----------------------------------------------------------------- burst

BURSTS = {
    "basic": dict(),
    "maxdiff": dict(maxdiff=True),
    "no_dm_scaling": dict(scale_by_dm=False),
    "momentum": dict(with_mom=True),
    "reanchor": dict(iters=12, reanchor_every=5),
    "batch2": dict(b=2),
    "batch2_reanchor_mom": dict(b=2, iters=12, reanchor_every=4,
                                with_mom=True),
    "non_square_5x5": dict(n=20, ny=12, nk=5),
    "iters0": dict(iters=0, with_mom=True),
}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", sorted(BURSTS))
def test_burst_corr_matches_jax(case, fused):
    """The port's ``burst_corr`` against JAX's, anchored on an explicit
    out0 (the true forward of slightly different weights, so XG0 is not
    trivial) or fused (out0=None)."""
    kw = dict(BURSTS[case])
    b, n = kw.pop("b", None), kw.pop("n", 16)
    ny, nk = kw.pop("ny", None), kw.pop("nk", 3)
    with_mom = kw.pop("with_mom", False)
    kw.setdefault("iters", 8)
    x, c, f, bb, p, mom = problem(seed=len(case), b=b, n=n, ny=ny, nk=nk)
    arrays = [x, c, f, bb, p]
    if not fused:
        arrays.append(jax_forward(x if b else x[None], c * 0.9, f, bb, p,
                                  kw.get("scale_by_dm", True))
                      .reshape(x.shape))
    j, t = both(*arrays)
    jm, tm = both(*mom) if with_mom else (None, None)
    out0 = (None, None) if fused else (j[5], t[5])
    want = jcorr.fft_burst_corr(j[0], None, out0[0], *j[1:5],
                                None if jm is None else tuple(jm),
                                lr=0.2, **kw)
    got = tcorr.burst_corr(t[0], None, out0[1], *t[1:5],
                           None if tm is None else tuple(tm), lr=0.2, **kw)
    assert_result(got, want)


@pytest.mark.parametrize("route", [True, False, "bf16"])
def test_fused_burst_window_routes_match_jax(route):
    x, c, f, bb, p, _ = problem(seed=11, b=2)
    j, t = both(x, c, f, bb, p)
    want = jcorr.fft_burst_corr(j[0], None, None, *j[1:], iters=10,
                                pallas_windows=route)
    got = tcorr.burst_corr(t[0], None, None, *t[1:], iters=10,
                           pallas_windows=route)
    assert_result(got, want)


def test_fused_burst_equals_explicit_out0():
    """Fused anchoring ≡ the explicit true forward as out0 (port only)."""
    x, c, f, bb, p, _ = problem(seed=5, b=2)
    t = both(x, c, f, bb, p)[1]
    out0 = tcorr._true_forward(t[0], *t[1:], True)
    fused = tcorr.burst_corr(t[0], None, None, *t[1:], iters=8)
    explicit = tcorr.burst_corr(t[0], None, out0, *t[1:], iters=8)
    assert_result(fused, explicit, mse_rtol=1e-4, w_tol=1e-5)


@pytest.mark.parametrize("nx,nk,d,m", [(16, 3, 2, 4), (24, 5, 2, 3),
                                       (32, 3, 3, 5)])
def test_burst_corr_matches_the_omega_space_oracle(nx, nk, d, m):
    """The corr burst against the port's ω-space ``fft_burst`` (the
    reference's loop, fft_backproplib.cu:1446-1464)."""
    x, c, f, bb, p, _ = problem(seed=nx, d=d, m=m, n=nx, nk=nk)
    t = both(x, c, f, bb, p)[1]
    out0 = tcorr._true_forward(t[0][None], *t[1:], True)[0]
    got = tcorr.burst_corr(t[0], t[0], out0, *t[1:], lr=0.2, iters=6)
    ref = fft_burst(t[0], t[0], out0, *t[1:], lr=0.2, iters=6, impl="dft")
    for name in ("mses", "c", "f", "b", "p"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name).numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=name)


def test_burst_corr_leaves_tf32_as_it_was():
    """The entry points run their products in IEEE float32 and restore the
    caller's TF32 setting."""
    x, c, f, bb, p, _ = problem(seed=2, b=1)
    t = both(x, c, f, bb, p)[1]
    from spectralae_torch.ops import window_kernels as wk
    seen = []
    real = wk._corr_windows

    def spy(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **k)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        wk._corr_windows = spy
        tcorr.burst_corr(t[0], t[0], tcorr._true_forward(t[0], *t[1:], True),
                         *t[1:], iters=2)
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        wk._corr_windows = real
        torch.backends.cuda.matmul.allow_tf32 = before
