"""The port's window kernels (K3, K4) against the JAX package (CPU).

On the CPU the wrappers run their plain PyTorch versions; the JAX package's
Pallas kernels ``corr_pair_windows`` and ``anchor_windows`` run in interpret
mode, as its own tests run them, and its XLA formulation runs as it is.
Tolerance: norm-relative 1e-6 — the same float32 products summed in
another order (the FFTs are taken once, by JAX, and handed to both).

Tests marked ``cuda`` launch the hand-written kernels against their plain
versions on the card and skip without one; they import no JAX::

    python -m pytest tests/test_torch_windows.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from spectralae_torch.ops import window_kernels as wk

torch.set_num_threads(1)

TOL = 1e-6
# the bf16 signal rounds X's planes by up to 2^-9 relative; the windows of
# the rounded signal stay within 2e-2 of the unrounded ones (the JAX
# package's own bound, tests/test_pallas_windows.py)
BF16_BAND = 2e-2


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def spectra(rng, b, c, nx, ny, scale=1.0):
    """Half-spectra of random real frames, complex64 numpy."""
    x = rng.standard_normal((b, c, nx, ny)).astype(np.float32) * scale
    return np.fft.rfft2(x).astype(np.complex64)


def rand_spec(rng, b, c, nx, nyr):
    return (rng.standard_normal((b, c, nx, nyr))
            + 1j * rng.standard_normal((b, c, nx, nyr))).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


# ------------------------------------------------------------------- K3

@pytest.mark.parametrize("B,D,E,nx,ny,hx,hy", [
    (2, 3, 3, 32, 32, 4, 4),      # square
    (1, 2, 3, 24, 16, 3, 2),      # cross-correlation, D != E, non-square
    (3, 1, 1, 16, 18, 5, 5),      # window wider than grid/2 (aliasing)
    (2, 2, 2, 16, 19, 2, 3),      # odd ny (nyr = 10)
])
def test_corr_pair_windows_matches_jax(B, D, E, nx, ny, hx, hy):
    import jax.numpy as jnp
    from spectralae.ops.pallas_windows import corr_pair_windows
    from spectralae.train import fft_corr
    rng = np.random.default_rng(B * 1000 + D * 100 + E * 10 + nx)
    nyr = ny // 2 + 1
    X, Z = rand_spec(rng, B, D, nx, nyr), rand_spec(rng, B, E, nx, nyr)
    before = dict(wk.LAUNCHES)
    got = wk.corr_pair_windows(_t(X), _t(Z), nx, ny, hx, hy)
    assert wk.LAUNCHES == before          # the CPU takes the plain version
    assert got.shape == (D, E, 2 * hx + 1, 2 * hy + 1)
    want = corr_pair_windows(jnp.asarray(X), jnp.asarray(Z), nx, ny, hx, hy,
                             interpret=True)
    assert rel(got, want) < TOL
    # and the JAX XLA formulation it fuses
    prods = jnp.mean(jnp.conj(X)[:, :, None] * Z[:, None],
                     axis=0).reshape(D * E, nx, nyr)
    xla = fft_corr._corr_windows(prods, nx, ny, hx, hy)
    assert rel(got.reshape(D * E, -1), np.asarray(xla).reshape(D * E, -1)) \
        < TOL


def test_corr_pair_windows_autocorrelation_mirror():
    """``Z is X``: the windows of conj(X_d)·X_e are those of conj(X_e)·X_d
    at the reversed lag, W[e,d](l) = W[d,e](−l)."""
    rng = np.random.default_rng(7)
    X = _t(rand_spec(rng, 2, 3, 32, 17))
    got = wk.corr_pair_windows(X, X, 32, 32, 4, 4)
    mirrored = torch.flip(got.transpose(0, 1), dims=(-2, -1))
    assert rel(got, mirrored) < TOL
    assert rel(got, wk.corr_pair_windows_plain(X, X.clone(), 32, 32, 4, 4)) \
        < TOL


# ------------------------------------------------------------------- K4

def _anchor_problem(seed, B, D, nx, ny, nk2, scale=1.0):
    rng = np.random.default_rng(seed)
    X = spectra(rng, B, D, nx, ny, scale)
    taps = (rng.standard_normal((D, D, nk2, nk2)) * 0.2).astype(np.float32)
    return X, taps, nk2 // 2, 1.0 / (4 * D)


@pytest.mark.parametrize("B,D,nx,ny,nk2", [
    (2, 3, 16, 16, 9),
    (1, 2, 24, 24, 5),
    (1, 2, 16, 19, 5),     # odd ny (nyr = 10)
    (2, 3, 20, 12, 9),     # non-square, window wider than the grid
])
def test_anchor_windows_matches_jax(B, D, nx, ny, nk2):
    import jax.numpy as jnp
    from spectralae.ops import dft as jdft
    from spectralae.ops import spectral as jspec
    from spectralae.ops.pallas_windows import anchor_windows
    from spectralae.train import fft_corr
    X, taps, h2, s1 = _anchor_problem(B * 100 + D, B, D, nx, ny, nk2)
    before = dict(wk.LAUNCHES)
    got = wk.anchor_windows(_t(X), _t(taps), nx, ny, h2, h2, s1)
    assert wk.LAUNCHES == before
    pallas = anchor_windows(jnp.asarray(X), jnp.asarray(taps), nx, ny, h2,
                            h2, s1, interpret=True)
    for name, g, w in zip(("XX", "EGw", "seg", "e0"), got, pallas):
        assert g.shape == w.shape, name
        assert rel(g, w) < TOL, name
    # the XLA formulation (fft_corr.py:504-527) with the same outputs
    Xj = jnp.asarray(X)
    K0f = jdft.kernel_spectrum(jnp.asarray(taps), nx, ny, precision="high")
    EG = jnp.sum(K0f[None] * Xj[:, None], axis=2) * s1 - Xj
    nyr = ny // 2 + 1

    def win(A, Bm, h):
        prods = jnp.mean(jnp.conj(A)[:, :, None] * Bm[:, None],
                         axis=0).reshape(D * D, nx, nyr)
        return fft_corr._corr_windows(prods, nx, ny, h, h)
    wv = jnp.asarray(jspec._hermitian_weights(nx, ny))
    xla = (win(Xj, Xj, 2 * h2), win(Xj, EG, h2),
           jnp.mean(jnp.sum((EG.real ** 2 + EG.imag ** 2) * wv,
                            axis=(-3, -2, -1))),
           jnp.mean(EG[:, :, 0, 0].real, axis=0))
    for name, g, w in zip(("XX", "EGw", "seg", "e0"), got, xla):
        assert rel(np.asarray(g).reshape(np.shape(w)), w) < TOL, name


@pytest.mark.parametrize("B,D,nx,ny,nk2", [
    (2, 3, 16, 16, 5), (1, 2, 16, 19, 5), (2, 3, 20, 12, 9)])
def test_anchor_windows_xx_mirror(B, D, nx, ny, nk2):
    """The kernel computes the upper XX pairs only and mirrors the rest:
    XX[e,d](l) = XX[d,e](−l) must hold for the whole tensor."""
    X, taps, h2, s1 = _anchor_problem(3, B, D, nx, ny, nk2)
    XX = wk.anchor_windows(_t(X), _t(taps), nx, ny, h2, h2, s1)[0]
    assert rel(XX, torch.flip(XX.transpose(0, 1), dims=(-2, -1))) < TOL


def test_anchor_windows_bf16_is_exact_on_rounded_signal():
    """The bf16 signal computes the exact float32 answer for the
    bf16-rounded signal (both EG terms share the rounded X), within the
    bf16 band of the unrounded one, and equals the JAX package's bf16
    route."""
    import jax.numpy as jnp
    from spectralae.ops.pallas_windows import anchor_windows
    X, taps, h2, s1 = _anchor_problem(7, 2, 3, 16, 16, 9, scale=1e3)
    Xt, tt = _t(X), _t(taps)
    got = wk.anchor_windows(Xt, tt, 16, 16, h2, h2, s1,
                            signal_dtype=torch.bfloat16)
    Xr = torch.complex(Xt.real.bfloat16().float(), Xt.imag.bfloat16().float())
    want = wk.anchor_windows(Xr, tt, 16, 16, h2, h2, s1)
    full = wk.anchor_windows(Xt, tt, 16, 16, h2, h2, s1)
    jax_bf16 = anchor_windows(jnp.asarray(X), jnp.asarray(taps), 16, 16, h2,
                              h2, s1, signal_dtype=jnp.bfloat16,
                              interpret=True)
    for g, w, f, j in zip(got, want, full, jax_bf16):
        assert rel(g, w) < TOL
        assert rel(g, j) < TOL
        assert rel(g, f) < BF16_BAND


@pytest.mark.parametrize("kw,what", [(dict(row_slab=0), "A12")])
def test_anchor_windows_unported_options_raise(kw, what):
    X, taps, h2, s1 = _anchor_problem(1, 1, 2, 16, 16, 5)
    with pytest.raises(NotImplementedError, match=what):
        wk.anchor_windows(_t(X), _t(taps), 16, 16, h2, h2, s1, **kw)


# ------------------------------------------------- K4 in mixed bin order

def _mixed_problem(seed, B, D, nx, ny, nk2, out_dtype=None):
    """Frames, their rfft2_mixed planes (the port's, plain on the CPU)
    and taps."""
    from spectralae_torch.ops import fft_kernels as fk
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, nx, ny)).astype(np.float32) * 30
    planes = fk.rfft2_mixed(_t(x), out_dtype=out_dtype)
    taps = (rng.standard_normal((D, D, nk2, nk2)) * 0.2).astype(np.float32)
    return x, planes, taps, nk2 // 2, 1.0 / (4 * D)


@pytest.mark.parametrize("B,D,nx,ny,nk2,max_m1,bf16", [
    (2, 3, 16, 16, 9, 512, False),
    (1, 2, 32, 48, 5, 512, False),
    (2, 3, 64, 32, 9, 8, False),       # forced recursion on both axes
    (2, 3, 16, 16, 9, 512, True)])     # bf16 planes
def test_anchor_windows_mixed_matches_jax(B, D, nx, ny, nk2, max_m1, bf16,
                                          monkeypatch):
    """The port's K4 on mixed planes (gathered to natural order) against
    JAX's ``anchor_windows(mixed=True)`` (permuted constants, interpret
    mode) on the same planes, and against the port's natural route on the
    same spectra."""
    import jax.numpy as jnp
    from spectralae.ops import pallas_fft as jfft
    from spectralae.ops.pallas_windows import anchor_windows
    from spectralae_torch.ops import fft_kernels as fk
    monkeypatch.setattr(fk, "_MAX_M1", max_m1)
    monkeypatch.setattr(jfft, "_MAX_M1", max_m1)
    x, (Xre, Xim), taps, h2, s1 = _mixed_problem(
        B + nx, B, D, nx, ny, nk2, torch.bfloat16 if bf16 else None)
    before = dict(wk.LAUNCHES)
    got = wk.anchor_windows((Xre, Xim), _t(taps), nx, ny, h2, h2, s1,
                            mixed=True)
    assert wk.LAUNCHES == before
    as_jax = (jnp.asarray(Xre.float().numpy()).astype(jnp.bfloat16)
              if bf16 else jnp.asarray(Xre.numpy()))
    as_jax_im = (jnp.asarray(Xim.float().numpy()).astype(jnp.bfloat16)
                 if bf16 else jnp.asarray(Xim.numpy()))
    want = anchor_windows((as_jax, as_jax_im), jnp.asarray(taps), nx, ny, h2,
                          h2, s1, mixed=True, interpret=True)
    natural = wk.anchor_windows(fk.to_natural((Xre, Xim), nx, ny), _t(taps),
                                nx, ny, h2, h2, s1)
    for name, g, w, n in zip(("XX", "EGw", "seg", "e0"), got, want,
                             natural):
        assert g.shape == w.shape, name
        assert rel(g, w) < TOL, name
        assert rel(g, n) < TOL, name


def test_anchor_windows_mixed_checks_its_input():
    _, (Xre, Xim), taps, h2, s1 = _mixed_problem(0, 1, 2, 16, 16, 5)
    with pytest.raises(ValueError, match="row-slab"):
        wk.anchor_windows((Xre, Xim), _t(taps), 16, 16, h2, h2, s1,
                          mixed=True, row_slab=0)
    with pytest.raises(ValueError, match="unsliced"):
        wk.anchor_windows((Xre[..., :9], Xim[..., :9]), _t(taps), 16, 16, h2,
                          h2, s1, mixed=True)
    with pytest.raises(TypeError, match="pair"):
        wk.anchor_windows(Xre, _t(taps), 16, 16, h2, h2, s1, mixed=True)


# ------------------------------------------------------- on the card

# the kernels sum in another order than the plain versions' matmuls, and
# K4 builds the anchor spectra through its own 81-term sums
CARD_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,E,n,ny,h,same", [
    (8, 3, 3, 128, 128, 4, True), (2, 2, 3, 40, 40, 3, False),
    (1, 3, 3, 33, 33, 5, True), (2, 2, 2, 24, 30, 2, True),
    (1, 3, 3, 8, 6600, 4, False)])    # nyr 3301: two ω_y chunks
def test_corr_pair_windows_kernel_matches_plain(cuda_device, B, D, E, n, ny,
                                                h, same):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(B, D, n, ny, device=cuda_device, generator=gen)
    X = torch.fft.rfft2(x)
    Z = X if same else torch.fft.rfft2(torch.randn(
        B, E, n, ny, device=cuda_device, generator=gen))
    before = wk.LAUNCHES["corr_pair_windows"]
    got = wk.corr_pair_windows(X, Z, n, ny, h, h)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["corr_pair_windows"] == before + 1
    want = wk.corr_pair_windows_plain(X, Z, n, ny, h, h)
    assert rel(got.cpu(), want.cpu()) < CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,n,ny,nk2,bf16", [
    (8, 3, 128, 128, 9, False), (8, 3, 128, 128, 9, True),
    (2, 2, 48, 30, 5, False), (1, 3, 64, 64, 9, False),
    (1, 2, 8, 5400, 5, False)])       # nyr 2701: two ω_y chunks
def test_anchor_windows_kernel_matches_plain(cuda_device, B, D, n, ny, nk2,
                                             bf16):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    X = torch.fft.rfft2(torch.randn(B, D, n, ny, device=cuda_device,
                                    generator=gen))
    taps = torch.randn(D, D, nk2, nk2, device=cuda_device, generator=gen) * .2
    sd = torch.bfloat16 if bf16 else None
    before = wk.LAUNCHES["anchor_windows"]
    got = wk.anchor_windows(X, taps, n, ny, nk2 // 2, nk2 // 2, 1 / (4 * D),
                            signal_dtype=sd)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["anchor_windows"] == before + 1
    want = wk.anchor_windows_plain(X, taps, n, ny, nk2 // 2, nk2 // 2,
                                   1 / (4 * D), signal_dtype=sd)
    for name, g, w in zip(("XX", "EGw", "seg", "e0"), got, want):
        assert rel(g.cpu(), w.cpu()) < CARD_TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,bf16", [(8, 128, False), (8, 128, True),
                                      (1, 1024, False), (2, 40, True)])
def test_anchor_windows_mixed_kernel_matches_plain(cuda_device, B, n, bf16):
    """K4 on the four-step FFT's mixed planes (float32 and bf16) against
    its plain version, which gathers them to natural order."""
    from spectralae_torch.ops import fft_kernels as fk
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.rand(B, 3, n, n, device=cuda_device, generator=gen) * 255
    planes = fk.rfft2_mixed(x, out_dtype=torch.bfloat16 if bf16 else None)
    taps = torch.randn(3, 3, 9, 9, device=cuda_device, generator=gen) * .2
    before = wk.LAUNCHES["anchor_windows"]
    got = wk.anchor_windows(planes, taps, n, n, 4, 4, 1 / 30, mixed=True)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["anchor_windows"] == before + 1
    want = wk.anchor_windows_plain(planes, taps, n, n, 4, 4, 1 / 30,
                                   mixed=True)
    for name, g, w in zip(("XX", "EGw", "seg", "e0"), got, want):
        assert rel(g.cpu(), w.cpu()) < CARD_TOL, name
