"""The pieces of the model axis on one process (CPU): the spectral conv
(K1's route and its plain version) and the coordinate conv (K2's route)
on a part of the whole conv.

A slice of a stage's output channels takes the whole stage's M for its
``1/M`` scale (``m_global``) and must equal the same
channels of the whole call; a slab of the grid's rows takes the bias only
where it holds row 0 and must equal the same rows; slices of the input
channels without a bias, summed and given the bias once, must equal the
whole call.  Each is held on the plain versions the CPU runs
(``spectral_conv_einsum``, :class:`SpectralConvFused` over the plain
``cmul_contract``, ``F.conv2d``), against the whole call and against the
JAX package's whole call, with the gradients of the slices against the
whole call's.  Tolerance: the same float32 products in another order,
1e-6 norm-relative (with bf16 operands too: the slice rounds the same
operands as the whole call).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spectralae.ops import coord as jcoord
from spectralae.ops import spectral as jspec
from spectralae_torch.ops import coord as tcoord
from spectralae_torch.ops import spectral as tspec
from spectralae_torch.ops import spectral_kernels as sk

torch.set_num_threads(1)

TOL = 1e-6
B, D, M, NX, NY = 2, 4, 6, 8, 10
NYR = NY // 2 + 1


def rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def spectra(seed: int = 0):
    """X ``[B, D, NX, NYR]``, C ``[M, D, NX, NYR]`` complex64, b ``[M]``."""
    rng = np.random.default_rng(seed)
    X = np.fft.rfft2(rng.normal(size=(B, D, NX, NY))).astype(np.complex64)
    C = np.fft.rfft2(rng.normal(size=(M, D, NX, NY))).astype(np.complex64)
    b = rng.normal(size=(M,)).astype(np.float32)
    return (torch.from_numpy(X), torch.from_numpy(C), torch.from_numpy(b))


CONVS = {
    "einsum": lambda X, C, b, **kw: tspec.spectral_conv_einsum(
        X, C, b, NX, NY, **kw),
    "fused": lambda X, C, b, compute_dtype=None, **kw:
        sk.spectral_conv_fused(X, C, b, NX, NY, True, compute_dtype, **kw),
}
DTYPES = {"f32": None, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", CONVS)
@pytest.mark.parametrize("n", [2, 3])
def test_output_channel_slices_are_the_whole_calls(route, dtype, n):
    """Each of ``n`` slices of C's output channels, at ``m_global`` M,
    is those channels of the whole call (and of JAX's)."""
    X, C, b = spectra()
    conv = CONVS[route]
    kw = dict(compute_dtype=DTYPES[dtype])
    whole = conv(X, C, b, **kw)
    jwhole = np.asarray(jspec.spectral_conv_einsum(
        jnp.asarray(X.numpy()), jnp.asarray(C.numpy()),
        jnp.asarray(b.numpy()), NX, NY, compute_dtype=(
            None if dtype == "f32" else jnp.bfloat16)))
    per = M // n
    for i in range(n):
        sl = slice(i * per, (i + 1) * per)
        part = conv(X, C[sl], b[sl], m_global=M, **kw)
        assert rel(part, whole[:, sl]) < TOL
        assert rel(part, jwhole[:, sl]) < TOL
        # the local M instead is the factor n the keyword is for
        wrong = conv(X, C[sl], b[sl], **kw)
        assert rel(wrong, whole[:, sl]) > 0.1


@pytest.mark.parametrize("route", CONVS)
@pytest.mark.parametrize("n", [2, 4])
def test_row_slabs_take_the_bias_once(route, n):
    """Slabs of the grid's rows of X and C, the bias only on the slab
    holding row 0: each is those rows of the whole call, and a slab given
    the bias off row 0 is not."""
    X, C, b = spectra(1)
    conv = CONVS[route]
    whole = conv(X, C, b)
    per = NX // n
    for i in range(n):
        rows = slice(i * per, (i + 1) * per)
        part = conv(X[:, :, rows], C[:, :, rows], b if i == 0 else None)
        assert part.shape == (B, M, per, NYR)
        assert rel(part, whole[:, :, rows]) < TOL
    off = conv(X[:, :, per:], C[:, :, per:], b)
    assert rel(off, whole[:, :, per:]) > 1e-3


@pytest.mark.parametrize("route", CONVS)
def test_input_channel_slices_sum_to_the_whole_call(route):
    """The contraction over slices of the input channels without a bias,
    summed, plus the bias once on the DC bin, is the whole call."""
    X, C, b = spectra(2)
    conv = CONVS[route]
    whole = conv(X, C, b)
    total = sum(conv(X[:, sl], C[:, sl], None)
                for sl in (slice(0, 2), slice(2, 4)))
    total[..., 0, 0] += b * (NX * NY)
    assert rel(total, whole) < TOL


def test_fused_gradients_of_a_slice():
    """:class:`SpectralConvFused` on a slice of the output channels: dC
    and db are the slice of the whole call's, and the slices' dX sum to
    the whole call's (the sum the model axis's copy does)."""
    X, C, b = spectra(3)
    g = torch.from_numpy(np.fft.rfft2(np.random.default_rng(4).normal(
        size=(B, M, NX, NY))).astype(np.complex64))

    def grads(Xv, Cv, bv, gv, **kw):
        leaves = [t.clone().requires_grad_() for t in (Xv, Cv, bv)]
        out = sk.spectral_conv_fused(*leaves, NX, NY, **kw)
        torch.real(torch.sum(gv.conj() * out)).backward()
        return [t.grad for t in leaves]
    dX, dC, db = grads(X, C, b, g)
    dX_sum = torch.zeros_like(dX)
    for sl in (slice(0, 3), slice(3, 6)):
        pX, pC, pb = grads(X, C[sl], b[sl], g[:, sl], m_global=M)
        assert rel(pC, dC[sl]) < TOL and rel(pb, db[sl]) < TOL
        dX_sum += pX
    assert rel(dX_sum, dX) < TOL


def coord_problem(seed: int = 5, nk: int = 3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D, 12, 12)).astype(np.float32) * 20
    c = rng.normal(size=(M, D, nk, nk)).astype(np.float32)
    b = rng.normal(size=(M,)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(b)


@pytest.mark.parametrize("tap", ["centered", "ref_cpu", "ref_gpu"])
def test_conv2d_slices_are_the_whole_call(tap):
    """``conv2d`` on a slice of the output channels at the whole stage's
    shape is those channels of the whole call (and of JAX's); slices of
    the input channels without a bias, summed, plus the bias, are the
    whole call."""
    x, c, b = coord_problem()
    whole = tcoord.conv2d(x, c, b, tap_mode=tap)
    jwhole = np.asarray(jcoord.conv2d(jnp.asarray(x.numpy()),
                                      jnp.asarray(c.numpy()),
                                      jnp.asarray(b.numpy()), tap_mode=tap))
    for sl in (slice(0, 3), slice(3, 6)):
        part = tcoord.conv2d(x, c[sl], b[sl], tap_mode=tap, m_global=M)
        assert rel(part, whole[:, sl]) < TOL
        assert rel(part, jwhole[:, sl]) < TOL
    total = sum(tcoord.conv2d(x[:, sl], c[:, sl], None, tap_mode=tap)
                for sl in (slice(0, 2), slice(2, 4)))
    assert rel(total + b[None, :, None, None], whole) < TOL


def test_conv2d_routes_on_the_whole_shape(monkeypatch):
    """The route is decided on the whole stage's shape: a [5, 10] slice
    of a 10 → 10 stage passes ``_kernel_shape`` (M·D = 50) but its stage
    does not (100), so it keeps cuDNN as on one rank; a 3 → 10 stage's
    [5, 3] slice keeps K2 (M·D = 30)."""
    assert tcoord._kernel_shape((5, 10, 5, 5))
    assert not tcoord._kernel_shape((10, 10, 5, 5))
    assert tcoord._kernel_shape((10, 3, 5, 5))
    seen = []
    monkeypatch.setattr(tcoord, "_auto_conv_kernel",
                        lambda x, shape: seen.append(shape) or False)
    x = torch.zeros(1, 10, 8, 8)
    c = torch.zeros(10, 10, 5, 5)
    tcoord.conv2d(x, c[:5], None, m_global=10)
    tcoord.conv2d(x[:, :3], c[:5, :3], None, m_global=10)
    tcoord.conv2d(x, c[:5], None)
    assert seen == [(10, 10, 5, 5), (10, 3, 5, 5), (5, 10, 5, 5)]
