"""Compact-support DFT transforms: kernel↔spectrum as small matmuls.

Port of :mod:`spectralae.ops.dft`.  Because conv kernels live on a tiny
Nk×Nl support (25 taps for 5×5), their full Nx×Ny spectra are rank-P DFT
projections:

  forward  (pad+rfft2,      fft_backproplib.cu:1276-1282):
      C(ω) = Σ_{k,l} c[k,l] · e^{-2πi ω·r_kl}
  inverse  (unnormalized C2R + shrink, fft_backproplib.cu:1219-1226):
      g[k,l] = Σ_ω w_ω · Re(D(ω) · e^{+2πi ω·r_kl})

with r_kl the corner-quadrant (circular) kernel positions and w_ω the
Hermitian double-count weights of the half-spectrum.  The phases are
separable — θ(ω) = θx_k(ωx) + θy_l(ωy) — so both transforms factor into
two per-axis products against tiny [Nk, Nx] / [Nl, Nyr] bases.

The products are ``torch.einsum`` in float32: plain tensor code, with no
hand-written kernel (the JAX package leaves them to XLA too).  On the card
they run at PyTorch's float32 matmul precision, which is IEEE float32
unless ``torch.backends.cuda.matmul.allow_tf32`` is switched on;
:func:`ieee_f32` holds them there.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from .._kernels import tensor_cache


@contextlib.contextmanager
def ieee_f32():
    """Run float32 matmuls and cuDNN convolutions in IEEE float32 (TF32
    off; cuDNN's default is on) inside the block, and restore the caller's
    settings after it."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


@functools.lru_cache(maxsize=None)
def _axis_bases(nk: int, nl: int, nx: int, ny: int):
    """Per-axis cos/sin bases + Hermitian column weights.

    Returns cx/sx [nk, nx], cy/sy [nl, nyr], hermy [nyr].
    """
    nyr = ny // 2 + 1
    rx = (np.arange(nk) - nk // 2) % nx           # circular kernel rows
    ry = (np.arange(nl) - nl // 2) % ny           # circular kernel cols
    px = 2 * np.pi * np.outer(rx, np.arange(nx)) / nx     # [nk, nx]
    py = 2 * np.pi * np.outer(ry, np.arange(nyr)) / ny    # [nl, nyr]
    from .spectral import _hermitian_weights
    herm = _hermitian_weights(nx, ny)
    return (np.cos(px).astype(np.float32), np.sin(px).astype(np.float32),
            np.cos(py).astype(np.float32), np.sin(py).astype(np.float32),
            herm)


@tensor_cache
def _bases_on(nk: int, nl: int, nx: int, ny: int, device: torch.device):
    """:func:`_axis_bases` as float32 tensors, kept on ``device`` — built
    outside inference mode, so a later backward may save them."""
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, device=device)
                     for a in _axis_bases(nk, nl, nx, ny))


@functools.lru_cache(maxsize=None)
def lag_basis(nx: int, ny: int, hx: int, hy: int):
    """Separable restricted-iDFT bases for centered lag windows.

    ``corr[v] = Re Σ_ω w(ω_y)·P(ω)·e^{2πi(v_x ω_x/nx + v_y ω_y/ny)}`` over
    the Hermitian half-spectrum (w doubles interior columns) — the
    irfft2·(Nx·Ny) value at lag ``v ∈ [−h, h]²``, computed as four small
    matmuls instead of a full inverse FFT.  Lag periodicity (``v mod N``) is
    inherent in the complex exponential, so windows wider than the grid
    alias exactly like the FFT path does.  Returns numpy arrays.
    """
    from .spectral import _hermitian_weights
    w = _hermitian_weights(nx, ny).astype(np.float64)
    nyr = ny // 2 + 1
    vy = np.arange(-hy, hy + 1)
    vx = np.arange(-hx, hx + 1)
    ay = 2.0 * np.pi * np.arange(nyr)[:, None] * vy[None, :] / ny
    ax = 2.0 * np.pi * np.arange(nx)[:, None] * vx[None, :] / nx
    return (np.asarray(np.cos(ax), np.float32),
            np.asarray(np.sin(ax), np.float32),
            np.asarray(w[:, None] * np.cos(ay), np.float32),
            np.asarray(w[:, None] * np.sin(ay), np.float32))


@tensor_cache
def _spectrum_bases_on(nk: int, nl: int, nx: int, ny: int,
                       device: torch.device):
    """:func:`_axis_bases` as :func:`kernel_spectrum`'s products read them,
    kept on ``device`` (built outside inference mode): ``ey`` ``[nl,
    2·nyr]`` float32, the column phases ``e^{-iθy}`` as (re, im) pairs;
    ``bx`` ``[2·nx, nk]`` float32, the row phases' cosines over their sines;
    ``exh`` ``[nk, nx]`` complex64, ``e^{+iθx}``, the rows' adjoint."""
    cx, sx, cy, sy, _ = _axis_bases(nk, nl, nx, ny)
    ey = np.stack([cy, -sy], axis=-1).reshape(nl, -1)
    bx = np.ascontiguousarray(np.concatenate([cx, sx], axis=1).T)
    exh = (cx + 1j * sx).astype(np.complex64)
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, device=device) for a in (ey, bx, exh))


def _spectrum(cb: torch.Tensor, ey: torch.Tensor, bx: torch.Tensor,
              nx: int) -> torch.Tensor:
    """The spectra ``[B, Nx, Nyr]`` of kernels ``cb`` ``[B, Nk, Nl]``, as
    two real products: the columns ``T = c·e^{-iθy}`` (its (re, im) pairs),
    then the rows' cosines and sines against them at once, ``A = cos·T`` and
    ``S = sin·T``, and ``C = A − i·S``.  Each bin is summed as the JAX
    package's einsums sum it, ``Σ cos·Tr + Σ sin·Ti`` and ``Σ cos·Ti −
    Σ sin·Tr``: the corr burst's anchor mismatch is this rounding's noise,
    and a data-parallel burst's distance from the single process follows
    it (``chip_smoke.py`` holds that distance)."""
    t = cb @ ey                                     # [B, Nk, 2·Nyr]
    q = torch.bmm(bx.expand(cb.shape[0], 2 * nx, bx.shape[1]), t)
    q = torch.view_as_complex(q.unflatten(-1, (-1, 2)))
    return torch.sub(q[:, :nx], q[:, nx:], alpha=1j)


class _KernelSpectrum(torch.autograd.Function):
    """:func:`_spectrum` with its adjoint as the backward: the rows'
    ``e^{+iθx}`` against the gradient in one batched complex product, then
    the columns' pairs, two launches where autograd through the forward's
    slices would fill and copy ``[B, 2·Nx, Nyr]`` buffers."""

    @staticmethod
    def forward(ctx, cb, ey, bx, exh):
        ctx.save_for_backward(ey, exh)
        return _spectrum(cb, ey, bx, exh.shape[1])

    @staticmethod
    def backward(ctx, g):
        ey, exh = ctx.saved_tensors
        gt = torch.bmm(exh.expand(g.shape[0], *exh.shape), g)
        return torch.view_as_real(gt).flatten(-2) @ ey.T, None, None, None


def kernel_spectrum(c: torch.Tensor, nx: int, ny: int,
                    precision=None) -> torch.Tensor:
    """``rfft2(kernel_pad(c))`` as two per-axis products.

    c: ``[..., Nk, Nl]`` real → ``[..., Nx, Ny//2+1]`` complex64.
    ``precision``: the JAX package's matmul-precision hint (``"high"``,
    ``"highest"``; the fused corr precompute passes ``"high"``).  Every
    value runs the products in IEEE float32 with TF32 off, which is at
    least as exact as any tier the hint names.

    Two batched products and a complex subtract (:func:`_spectrum`), for
    few operations on the host; where autograd needs the kernels' gradient,
    the adjoint's two products (:class:`_KernelSpectrum`).
    """
    if precision is not None:
        with ieee_f32():
            return kernel_spectrum(c, nx, ny)
    nk, nl = c.shape[-2], c.shape[-1]
    ey, bx, exh = _spectrum_bases_on(nk, nl, nx, ny, c.device)
    cb = c.reshape(-1, nk, nl)
    if c.requires_grad and torch.is_grad_enabled():
        out = _KernelSpectrum.apply(cb, ey, bx, exh)
    else:
        out = _spectrum(cb, ey, bx, nx)
    return out.reshape(c.shape[:-2] + out.shape[-2:])


def kernel_project(D: torch.Tensor, nk: int, nl: int, nx: int,
                   ny: int) -> torch.Tensor:
    """``kernel_shrink(irfft2_unnormalized(D))`` as two per-axis products.

    D: ``[..., Nx, Ny//2+1]`` complex (Hermitian-consistent) →
    ``[..., Nk, Nl]`` real — the spatial gradient restricted to the compact
    support, with cuFFT's unnormalized C2R scaling.

    g[k,l] = Σ_ω w(ωy)·[Dr·cos(θx+θy) − Di·sin(θx+θy)], expanded over the
    separable angle sum into four (rows ∘ cols) contractions.
    """
    cx, sx, cy, sy, w = _bases_on(nk, nl, nx, ny, D.device)
    Dr = D.real * w
    Di = D.imag * w
    # columns: A·e^{±iθy} partials        [..., Nx, Nl]
    rc = torch.einsum("...xy,ly->...xl", Dr, cy)
    rs = torch.einsum("...xy,ly->...xl", Dr, sy)
    ic = torch.einsum("...xy,ly->...xl", Di, cy)
    is_ = torch.einsum("...xy,ly->...xl", Di, sy)
    # rows: contract ωx                   [..., Nk, Nl]
    return (torch.einsum("kx,...xl->...kl", cx, rc)
            - torch.einsum("kx,...xl->...kl", sx, rs)
            - torch.einsum("kx,...xl->...kl", sx, ic)
            - torch.einsum("kx,...xl->...kl", cx, is_))
