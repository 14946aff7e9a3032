"""spectralae_torch.ops.spectral / ops.dft against the JAX package (CPU).

Inputs come from a numpy seed and go through both frameworks.  Tolerances
are norm-relative: gathers, masks and index maps are exact (0); float32
FFT and DFT chains 1e-5 (two FFT libraries, sums in another order); the
plain pointwise products 1e-6 (the same float32 products, another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spectralae.ops import dft as jdft
from spectralae.ops import spectral as jspec
from spectralae_torch.ops import dft as tdft
from spectralae_torch.ops import spectral as tspec

torch.set_num_threads(1)

FFT_TOL = 1e-5
PLAIN_TOL = 1e-6


def rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def real(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def spectra(rng, *shape):
    """rfft2 of a real float32 field, as complex64 numpy."""
    return np.fft.rfft2(real(rng, *shape)).astype(np.complex64)


@pytest.mark.parametrize("nx,ny", [(16, 16), (12, 20), (15, 9)])
def test_rfft2_irfft2_match_jax(nx, ny):
    x = real(np.random.default_rng(0), 2, 3, nx, ny)
    X_t = tspec.rfft2(torch.from_numpy(x))
    X_j = np.asarray(jspec.rfft2(jnp.asarray(x)))
    assert X_t.dtype == torch.complex64 and X_t.shape == X_j.shape
    assert rel(X_t, X_j) < FFT_TOL
    assert rel(tspec.irfft2(X_t, (nx, ny)),
               jspec.irfft2(jnp.asarray(X_j), (nx, ny))) < FFT_TOL
    assert rel(tspec.irfft2_unnormalized(X_t, (nx, ny)),
               jspec.irfft2_unnormalized(jnp.asarray(X_j), (nx, ny))) \
        < FFT_TOL


@pytest.mark.parametrize("nx,ny,nxs,nys", [
    (16, 16, 8, 8), (18, 18, 9, 9), (20, 12, 10, 6),      # crop
    (8, 8, 16, 16), (9, 9, 18, 18), (6, 10, 12, 20)])     # zero-pad
def test_resize_maps_are_the_jax_maps(nx, ny, nxs, nys):
    for got, want in zip(tspec._resize_maps(nx, ny, nxs, nys),
                         jspec._resize_maps(nx, ny, nxs, nys)):
        np.testing.assert_array_equal(got, want)


POOL_CASES = [
    (16, 16, 2), (18, 18, 2), (20, 12, 2), (24, 24, 3),   # down, even/odd
    (8, 8, -2), (9, 9, -2), (6, 10, -3), (16, 16, 1)]     # up, identity


def pooled(nx, ny, scale):
    if abs(scale) <= 1:
        return nx, ny
    return (nx // scale, ny // scale) if scale > 0 else (nx * -scale,
                                                         ny * -scale)


@pytest.mark.parametrize("nx,ny,scale", POOL_CASES)
def test_spectral_pool_matches_jax_exactly(nx, ny, scale):
    X = spectra(np.random.default_rng(1), 2, 3, nx, ny)
    got, gx, gy = tspec.spectral_pool(torch.from_numpy(X), nx, ny, scale)
    want, wx, wy = jspec.spectral_pool(jnp.asarray(X), nx, ny, scale)
    assert (gx, gy) == (wx, wy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nx,ny,scale", POOL_CASES)
def test_resize_maps_invert_where_the_mask_is_one(nx, ny, scale):
    """The resize's row and column maps are one to one where its mask is
    1 (JAX's masks and maps), so the adjoint is the remap on the inverse
    maps: ``inverse[map[i]] == i`` at every kept bin, and -1 at every input
    bin that no output bin reads."""
    nxs, nys = pooled(nx, ny, scale)
    jmaps = jspec._resize_maps(nx, ny, nxs, nys)
    fwd = tspec._remap_maps(nx, ny, nxs, nys, False)
    inv = tspec._remap_maps(nx, ny, nxs, nys, True)
    for m, mask, f, i, n in zip(jmaps[::2], jmaps[1::2], fwd, inv,
                                (nx, ny // 2 + 1)):
        kept = np.flatnonzero(np.asarray(mask) > 0)
        m = np.asarray(m)
        assert len(set(m[kept].tolist())) == len(kept)      # one to one
        np.testing.assert_array_equal(f, np.where(np.asarray(mask) > 0, m,
                                                  -1))
        assert len(i) == n
        np.testing.assert_array_equal(i[m[kept]], kept)
        assert (np.delete(i, m[kept]) == -1).all()


@pytest.mark.parametrize("nx,ny,scale", POOL_CASES)
def test_resize_route_equals_the_gathers_bit_for_bit(nx, ny, scale):
    """The kernel's route forced onto the CPU (a hook sees every kernel
    wrapper's call): its forward equals the plain gathers' (the resize
    before the kernel), and its gradient autograd's through them."""
    from spectralae_torch import _kernels
    nxs, nys = pooled(nx, ny, scale)
    rng = np.random.default_rng(2)
    X = torch.from_numpy(spectra(rng, 2, 3, nx, ny)).requires_grad_(True)
    g = torch.from_numpy(spectra(rng, 2, 3, nxs, nys))
    want = tspec.resize_plain(X, nx, ny, nxs, nys)
    want_grad, = torch.autograd.grad(want, X, g)
    seen = []

    def hook(fn, args, kwargs):
        seen.append(fn.__name__)
        return fn(*args, **kwargs)
    _kernels.HOOK = hook
    try:
        got = tspec.spectral_resize(X, nx, ny, nxs, nys)
        got_grad, = torch.autograd.grad(got, X, g)
    finally:
        _kernels.HOOK = None
    assert seen == ["spectral_resize"] * 2
    assert torch.equal(got, want) and torch.equal(got_grad, want_grad)
    np.testing.assert_array_equal(
        got.detach().numpy(),
        np.asarray(jspec.spectral_resize(jnp.asarray(X.detach().numpy()),
                                         nx, ny, nxs, nys)))


@pytest.mark.parametrize("nk,nl,nx,ny", [(5, 5, 16, 16), (3, 5, 12, 10),
                                         (17, 17, 32, 32)])
def test_kernel_transforms_match_jax(nk, nl, nx, ny):
    """kernel_pad/shrink exact; kernel_rfft (DFT products below 256 taps,
    padded FFT above) and kernel_irfft to the FFT tolerance."""
    c = real(np.random.default_rng(2), 4, 3, nk, nl)
    ct, cj = torch.from_numpy(c), jnp.asarray(c)
    padded = tspec.kernel_pad(ct, nx, ny)
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jspec.kernel_pad(cj, nx, ny)))
    np.testing.assert_array_equal(tspec.kernel_shrink(padded, nk, nl).numpy(),
                                  c)
    C_t = tspec.kernel_rfft(ct, nx, ny)
    C_j = np.asarray(jspec.kernel_rfft(cj, nx, ny))
    assert rel(C_t, C_j) < FFT_TOL
    assert rel(tspec.kernel_irfft(C_t, nk, nl, nx, ny),
               jspec.kernel_irfft(jnp.asarray(C_j), nk, nl, nx, ny)) \
        < FFT_TOL


@pytest.mark.parametrize("nk,nl,nx,ny", [(5, 5, 16, 16), (3, 3, 12, 9)])
def test_dft_products_match_jax(nk, nl, nx, ny):
    rng = np.random.default_rng(3)
    c = real(rng, 2, 3, nk, nl)
    got = tdft.kernel_spectrum(torch.from_numpy(c), nx, ny)
    assert rel(got, jdft.kernel_spectrum(jnp.asarray(c), nx, ny)) < FFT_TOL
    # and the product is the padded transform it stands for
    assert rel(got, np.fft.rfft2(
        tspec.kernel_pad(torch.from_numpy(c), nx, ny).numpy())) < FFT_TOL
    D = spectra(rng, 2, 3, nx, ny)
    assert rel(tdft.kernel_project(torch.from_numpy(D), nk, nl, nx, ny),
               jdft.kernel_project(jnp.asarray(D), nk, nl, nx, ny)) \
        < FFT_TOL
    for got_b, want_b in zip(tdft.lag_basis(nx, ny, 2, 3),
                             jdft.lag_basis(nx, ny, 2, 3)):
        np.testing.assert_array_equal(got_b, want_b)
    for got_b, want_b in zip(tdft._axis_bases(nk, nl, nx, ny),
                             jdft._axis_bases(nk, nl, nx, ny)):
        np.testing.assert_array_equal(got_b, want_b)


@pytest.mark.parametrize("lead,nk,nl,nx,ny", [
    ((), 5, 5, 16, 16), ((3,), 3, 3, 12, 9), ((4, 3), 5, 5, 16, 16),
    ((2, 3), 3, 5, 8, 15)])
def test_kernel_spectrum_and_its_gradient_match_float64(lead, nk, nl, nx,
                                                        ny):
    """The two products of ``kernel_spectrum`` (a real column product read
    as complex, a batched complex row product) against the phases' sum in
    float64: the spectra, contiguous, and autograd's gradient of the
    kernels."""
    rng = np.random.default_rng(5)
    c = real(rng, *lead, nk, nl)
    G = spectra(rng, *lead, nx, ny)
    cx, sx, cy, sy, _ = (torch.from_numpy(a).double()
                         for a in tdft._axis_bases(nk, nl, nx, ny))
    c64 = torch.from_numpy(c).double().requires_grad_()
    want = torch.einsum("kx,...kl,ly->...xy", torch.complex(cx, -sx),
                        c64.to(torch.complex128), torch.complex(cy, -sy))
    want_g, = torch.autograd.grad(want, c64,
                                  torch.from_numpy(G).to(torch.complex128))
    ct = torch.from_numpy(c).requires_grad_()
    got = tdft.kernel_spectrum(ct, nx, ny)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert got.is_contiguous()
    assert rel(got.detach(), want.detach()) < FFT_TOL
    got_g, = torch.autograd.grad(got, ct, torch.from_numpy(G))
    assert rel(got_g, want_g) < FFT_TOL


@pytest.mark.parametrize("scale_by_dm", [True, False])
def test_spectral_conv_einsum_matches_jax(scale_by_dm):
    rng = np.random.default_rng(4)
    nx = ny = 16
    X = spectra(rng, 2, 3, nx, ny)
    C = spectra(rng, 5, 3, nx, ny)
    b = real(rng, 5)
    got = tspec.spectral_conv(torch.from_numpy(X), torch.from_numpy(C),
                              torch.from_numpy(b), nx, ny,
                              scale_by_dm=scale_by_dm)
    want = jspec.spectral_conv_einsum(jnp.asarray(X), jnp.asarray(C),
                                      jnp.asarray(b), nx, ny,
                                      scale_by_dm=scale_by_dm)
    assert rel(got, want) < PLAIN_TOL


def test_spectral_conv_reduced_precision_raises():
    """bf16 operands are ported; any other reduced type raises."""
    X = torch.zeros(1, 2, 8, 5, dtype=torch.complex64)
    C = torch.zeros(3, 2, 8, 5, dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="bf16 operands only"):
        tspec.spectral_conv(X, C, torch.zeros(3), 8, 8,
                            compute_dtype=torch.float16)


@pytest.mark.parametrize("nx,ny", [(16, 16), (12, 9)])
def test_parseval_mse_and_weights_match_jax(nx, ny):
    rng = np.random.default_rng(5)
    X, O = spectra(rng, 2, 3, nx, ny), spectra(rng, 2, 3, nx, ny)
    np.testing.assert_array_equal(tspec._hermitian_weights(nx, ny),
                                  jspec._hermitian_weights(nx, ny))
    got = float(tspec.parseval_mse(torch.from_numpy(X), torch.from_numpy(O),
                                   3, 3, nx, ny))
    want = float(jspec.parseval_mse(jnp.asarray(X), jnp.asarray(O), 3, 3,
                                    nx, ny))
    assert abs(got - want) <= PLAIN_TOL * abs(want)
