"""Momentum-space training: the 100-iteration frozen-input burst.

Port of :mod:`spectralae.train.fft`, the ω-space oracle that the
correlation-space burst (:mod:`spectralae_torch.train.fft_corr`) is held
against.  The reference's ``backprop_fft`` (source/fft_backproplib.cu:
1381-1511) FFTs the training patch once, then runs 100 inner iterations of:

  1. analytic frequency-domain gradients (``gradient_k_io``, 395-475),
  2. inverse-FFT the gradient spectra (*unnormalized* C2R, 1219-1220),
  3. project onto the compact Nk×Nl kernel support (``shrink_k``, 1225-1226),
  4. inertia update in coordinate space (α=0.9 hard-coded, 608),
  5. re-pad + forward-FFT the updated kernels (1276-1282),
  6. recompute the output spectrum through the two-stage frequency conv
     (1460-1461) and log the Parseval MSE.

The loop is a Python loop of tensor ops; the MSE trajectory is collected
on the device and returned after the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..losses.losses import diversity_gradients
from ..ops import dft, spectral
from ..optim.update import burst_inertia


class FFTBurstResult(NamedTuple):
    c: torch.Tensor     # [M, D, Nk, Nl] updated encoder kernels
    f: torch.Tensor     # [D, M, Nk, Nl] updated decoder kernels
    b: torch.Tensor     # [M] encoder biases
    p: torch.Tensor     # [D] decoder biases
    mom: tuple          # (Dc, Df, Db, Dp) momentum carry
    mses: torch.Tensor  # [iters+1] Parseval MSE trajectory (index 0 = initial)


def zero_moms(c, f, b, p) -> tuple:
    """The burst's zero momentum 4-tuple (Dc, Df, Db, Dp)."""
    return tuple(torch.zeros_like(t) for t in (c, f, b, p))


def gradient_k_io(X: torch.Tensor, Y: torch.Tensor, O: torch.Tensor,
                  Cf: torch.Tensor, Ff: torch.Tensor, b: torch.Tensor,
                  nx: int, ny: int):
    """Analytic momentum-space gradients of the Parseval MSE.

    Closed forms (fft_backproplib.cu:395-475):

      E        = O − Y                       (output − expected, per bin)
      S_m      = Σ_d E_d · conj(F_{d,m})
      H_m      = Σ_d C_{m,d} · X_d  (+ b_m·Nx·Ny at DC; *no* 1/M here — a
                 reference quirk: the forward scales by 1/M, the gradient
                 does not)
      dC_{m,d} = S_m · conj(X_d) / Norm
      dF_{d,m} = E_d · conj(H_m) / Norm
      dB_m     = Re(S_m(0,0)) · Nx·Ny / Norm
      dP_d     = Re(E_d(0,0)) · Nx·Ny / Norm

    with Norm = 2·M·D·(Nx·Ny)².
    """
    dM, dD = Cf.shape[0], Cf.shape[1]
    norm = nx * ny
    Norm = norm * 2.0 * dM * dD * nx * ny
    E = O - Y
    S = torch.einsum("dxy,dmxy->mxy", E, Ff.conj())
    H = torch.einsum("mdxy,dxy->mxy", Cf, X)
    H[:, 0, 0] += b.to(H.dtype) * norm
    dc = torch.einsum("mxy,dxy->mdxy", S, X.conj()) / Norm
    df = torch.einsum("dxy,mxy->dmxy", E, H.conj()) / Norm
    db = S[:, 0, 0].real * norm / Norm
    dp = E[:, 0, 0].real * norm / Norm
    return dc, df, db, dp


def _kernel_spectrum(c, nx, ny, impl):
    """Compact kernel → half-spectrum: FFT path (pad+rfft2) or the
    compact-support DFT product (:mod:`spectralae_torch.ops.dft`)."""
    if impl == "dft":
        return dft.kernel_spectrum(c, nx, ny)
    return spectral.kernel_rfft(c, nx, ny)


def _kernel_gradient(D, nk, nl, nx, ny, impl):
    """Gradient spectrum → compact spatial gradient (unnormalized C2R +
    shrink projection, fft_backproplib.cu:1219-1226)."""
    if impl == "dft":
        return dft.kernel_project(D, nk, nl, nx, ny)
    return spectral.kernel_shrink(
        spectral.irfft2_unnormalized(D, (nx, ny)), nk, nl)


def _two_stage_output(X, c, f, b, p, nx, ny, scale_by_dm=True, impl="fft"):
    """Recompute the output spectrum O = F·(C·X) (fft_backproplib.cu:1460-1461)."""
    Cf = _kernel_spectrum(c, nx, ny, impl)
    Ff = _kernel_spectrum(f, nx, ny, impl)
    H = spectral.spectral_conv_einsum(X[None], Cf, b, nx, ny,
                                      scale_by_dm=scale_by_dm)[0]
    O = spectral.spectral_conv_einsum(H[None], Ff, p, nx, ny,
                                      scale_by_dm=scale_by_dm)[0]
    return O, Cf, Ff


def fft_burst(x: torch.Tensor, expout: torch.Tensor, out0: torch.Tensor,
              c: torch.Tensor, f: torch.Tensor, b: torch.Tensor,
              p: torch.Tensor, mom: tuple | None = None, *,
              lr: float = 0.2, alpha: float = 0.9, iters: int = 100,
              maxdiff: bool = False, w0: float = 1.0, w1: float = 10.0,
              scale_by_dm: bool = True, impl: str = "dft") -> FFTBurstResult:
    """One ``backprop_fft`` call: a full frozen-input optimization burst.

    Args:
      x: ``[D, h, w]`` input patch (frozen for the whole burst).
      expout: ``[D, h, w]`` expected output (the reference passes the input).
      out0: ``[D, h, w]`` current network output (seeds the first gradient).
      c/f/b/p: compact kernels and biases of the trained stage pair.
      mom: optional (Dc, Df, Db, Dp) momentum carry; zeros when None —
        the reference zeroes them per call (fft_backproplib.cu:1420-1423).
      lr: the keyboard lr; the effective rate is ``0.1·lr``
        (fft_backproplib.cu:1445).
      alpha: inertia weight — hard-coded 0.9 in the reference (line 608).
      maxdiff: multiobjective kernel-diversity combination
        ``g ← w0·g − w1·g_div`` (fft_backproplib.cu:1252, 665-694).
      impl: kernel↔spectrum transform — "dft" (default) the compact-support
        products (:mod:`spectralae_torch.ops.dft`); "fft" the literal
        pad+rfft2 path.
    """
    nx, ny = x.shape[-2], x.shape[-1]
    dM, dD, nk, nl = c.shape
    del_eff = 0.1 * lr
    X = spectral.rfft2(x)
    Y = spectral.rfft2(expout)
    O = spectral.rfft2(out0)
    Dc, Df, Db, Dp = mom if mom is not None else zero_moms(c, f, b, p)
    mses = torch.zeros(iters + 1, dtype=x.dtype, device=x.device)
    mses[0] = spectral.parseval_mse(Y, O, dD, dM, nx, ny)
    # kernel spectra are carried across iterations (computed once per
    # update), as the reference reuses its device buffers
    # (fft_backproplib.cu:1281-1282)
    Cf = _kernel_spectrum(c, nx, ny, impl)
    Ff = _kernel_spectrum(f, nx, ny, impl)
    for i in range(iters):
        dc, df, db, dp = gradient_k_io(X, Y, O, Cf, Ff, b, nx, ny)
        # spectral grads → spatial, projected to compact support
        gc = _kernel_gradient(dc, nk, nl, nx, ny, impl)
        gf = _kernel_gradient(df, nk, nl, nx, ny, impl)
        gb, gp = db, dp
        if maxdiff:
            cd, fd, bd, pd = diversity_gradients(c, f, b, p)
            gc = w0 * gc - w1 * cd
            gf = w0 * gf - w1 * fd
            gb = w0 * gb - w1 * bd
            gp = w0 * gp - w1 * pd
        c, Dc = burst_inertia(c, gc, Dc, del_eff, alpha)
        f, Df = burst_inertia(f, gf, Df, del_eff, alpha)
        b, Db = burst_inertia(b, gb, Db, del_eff, alpha)
        p, Dp = burst_inertia(p, gp, Dp, del_eff, alpha)
        O, Cf, Ff = _two_stage_output(X, c, f, b, p, nx, ny, scale_by_dm,
                                      impl)
        mses[i + 1] = spectral.parseval_mse(Y, O, dD, dM, nx, ny)
    return FFTBurstResult(c=c, f=f, b=b, p=p, mom=(Dc, Df, Db, Dp),
                          mses=mses)
