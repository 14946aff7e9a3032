"""Pixel-space fused-anchor precompute: the FFT-free formulation.

Port of :mod:`spectralae.ops.pixel_corr` (ROADMAP A6), plain PyTorch: it
replaces no TPU kernel and has none.  The corr-burst precompute
(:func:`spectralae_torch.train.fft_corr.corr_precompute_fused`) consumes
only *centred lag windows* of signal cross-correlations plus a few
scalars, and by Parseval each of them is a plain pixel-space quantity:

    XX[d,e][u,v]  = Nx·Ny · mean_b Σ_p x_d(p) · x_e(p + (u,v))      (circular)
    eg_e          = s1 · (K₀ ⊛ x)_e − x_e        (circular conv with the
                    composed taps: the continuum anchor error in pixels)
    EGw[d,e][u,v] = Nx·Ny · mean_b Σ_p x_d(p) · eg_e(p + (u,v))
    seg           = Nx·Ny · mean_b Σ_{e,p} eg²           (Σ w |EG|², Parseval)
    e0[e]         = mean_b Σ_p eg_e(p)                    (EG DC bin)
    X0[d]         = mean_b Σ_p x_d(p)                     (X DC bin)

The lag windows are shift-stack contractions,

    XX = einsum("bduij,bevij->deuv", A, B) · Nx·Ny / B,
    A[(d,u)](i,j) = x_d(i−u, j)   (row shifts, u ∈ [−h, h]),
    B[(e,v)](i,j) = x_e(i, j+v)   (column rolls),

in the lag order of :func:`spectralae_torch.ops.dft.lag_basis` (index 0 ↔
−h); circular rolls reproduce the DFT's mod-N lag aliasing exactly.  The
anchoring-precision contract holds: ``eg`` is computed per pixel as a
float32 contraction minus x, never derived from the signal-energy-scale
XX tensors.  The shift stacks are materialised (2·(4h+1) copies of the
frames), so this is a correctness alternative, not a speed path.  Every
product runs in IEEE float32 (TF32 off).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dft import ieee_f32


def _row_stack(x: torch.Tensor, h: int) -> torch.Tensor:
    """``[B, D, nx, ny] → [B, D, 2h+1, nx, ny]``, entry u ↦ x(i−(u−h), j)."""
    return torch.stack([torch.roll(x, s, dims=-2) for s in range(-h, h + 1)],
                       dim=2)


def _col_stack(x: torch.Tensor, h: int) -> torch.Tensor:
    """``[B, D, nx, ny] → [B, D, 2h+1, nx, ny]``, entry v ↦ x(i, j+(v−h))."""
    return torch.stack([torch.roll(x, -s, dims=-1) for s in range(-h, h + 1)],
                       dim=2)


@ieee_f32()
def anchor_error_pixel(x: torch.Tensor, K0taps: torch.Tensor,
                       s1: float) -> torch.Tensor:
    """``eg = s1·(K₀ ⊛ x) − x``: the continuum anchor error in pixel space.

    ``K0taps [E, D, nk2, nl2]`` are centred composed-kernel taps; the
    circular convolution ``(K₀ ⊛ x)_e(p) = Σ_{d,t} K₀[e,d,t]·x_d(p−t)`` is
    one correlation with the flipped taps over a circularly padded input,
    in float32 (the anchor is never measured back, so its rounding would be
    a phantom error the burst chases).
    """
    hx2, hy2 = K0taps.shape[-2] // 2, K0taps.shape[-1] // 2
    xpad = F.pad(x, (hy2, hy2, hx2, hx2), mode="circular")
    conv = F.conv2d(xpad, torch.flip(K0taps, dims=(-2, -1)))
    return s1 * conv - x


@ieee_f32()
def pixel_anchor_windows(x: torch.Tensor, K0taps: torch.Tensor, hx2: int,
                         hy2: int, s1: float):
    """FFT-free fused-anchor precompute on pixel frames.

    Args:
      x: ``[B, D, nx, ny]`` real frames (not spectra).
      K0taps: ``[D, D, 2hx2+1, 2hy2+1]`` composed anchor taps.

    Returns ``(XX [D,D,4hx2+1,4hy2+1], EGw [D,D,2hx2+1,2hy2+1], seg, e0,
    X0)``: the :func:`spectralae_torch.ops.window_kernels.anchor_windows`
    contract plus the X DC scalars.
    """
    B = x.shape[0]
    nx, ny = x.shape[-2], x.shape[-1]
    hx4, hy4 = 2 * hx2, 2 * hy2
    norm = float(nx * ny) / B
    eg = anchor_error_pixel(x, K0taps, s1)
    A4 = _row_stack(x, hx4)
    XX = torch.einsum("bduij,bevij->deuv", A4, _col_stack(x, hy4)) * norm
    A2 = A4[:, :, hx4 - hx2:hx4 + hx2 + 1]
    EGw = torch.einsum("bduij,bevij->deuv", A2, _col_stack(eg, hy2)) * norm
    seg = torch.sum(eg * eg) * norm
    e0 = torch.sum(eg, dim=(0, -2, -1)) / B
    X0 = torch.sum(x, dim=(0, -2, -1)) / B
    return XX, EGw, seg, e0, X0
