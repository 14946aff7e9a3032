"""Losses: reconstruction MSE variants and the kernel-diversity objective.

Port of :mod:`spectralae.losses.losses`.  The reference's multiobjective
mode combines the reconstruction gradient with a *repulsion* gradient that
pushes kernels apart:

    g ← w0·g_recon − w1·g_div,   w0=1, w1=10   (fft_backproplib.cu:1252)

``gradient_diff`` (fft_backproplib.cu:709-753) is the gradient of
``½·Σ_pairs log‖c_md − c_m'd'‖²`` (plus ``Σ log|b_m − b_m'|`` for biases),
restricted to pairs with *both* indices different (a reference quirk, line
724).  Both forms are provided: the explicit vectorized gradient and the
scalar loss for autograd.  :func:`stage_diversity` is the batched train
step's form (``train/modern.py``, ``maxdiff``): one stage at a time, by two
matrix products instead of the pairwise differences.
"""

from __future__ import annotations

import torch

from .._kernels import tensor_cache
from ..core import profiling
from ..ops.dft import ieee_f32


def mse_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unnormalized SSE — the CPU path's printed 'mse' (netlib.cpp:374-385)."""
    return torch.sum((a - b) ** 2)


def mse_coord(a: torch.Tensor, b: torch.Tensor, m: int, nk: int,
              nl: int) -> torch.Tensor:
    """The GPU coord path's printed mse: SSE / (D·M·Nk·Nl·Nx·Ny)
    (backproplib.cu:303, 356)."""
    d, nx, ny = a.shape[-3], a.shape[-2], a.shape[-1]
    return mse_raw(a, b) / (d * m * nk * nl * nx * ny)


def _pair_mask(m: int, d: int, device=None) -> torch.Tensor:
    """[M,D,M,D] mask of pairs with m1≠m AND d1≠d (fft_backproplib.cu:724)."""
    mm = ~torch.eye(m, dtype=torch.bool, device=device)
    dd = ~torch.eye(d, dtype=torch.bool, device=device)
    return mm[:, None, :, None] & dd[None, :, None, :]


def _inverse_off_diagonal(v: torch.Tensor) -> torch.Tensor:
    """``Σ_{j≠i} 1/(v_i − v_j)``, with a zero difference counted as 1."""
    diff = v[:, None] - v[None, :]
    inv = 1.0 / torch.where(diff == 0, torch.ones_like(diff), diff)
    off = ~torch.eye(v.shape[0], dtype=torch.bool, device=v.device)
    return torch.sum(torch.where(off, inv, torch.zeros_like(inv)), dim=1)


def diversity_gradients(c: torch.Tensor, f: torch.Tensor, b: torch.Tensor,
                        p: torch.Tensor):
    """Vectorized ``gradient_diff``: repulsion gradients for (c, f, b, p).

    c: [M,D,Nk,Nl]; f: [D,M,Nk,Nl]; b: [M]; p: [D].
    Returns (cd [M,D,Nk,Nl], fd [D,M,Nk,Nl], bd [M], pd [D]).
    """
    M, D = c.shape[0], c.shape[1]

    def repel(k, mask):  # k: [A,B,Nk,Nl], pairs over (A,B)
        diff = k[:, :, None, None] - k[None, None, :, :]      # [A,B,A,B,Nk,Nl]
        den = torch.sum(diff * diff, dim=(-2, -1))            # [A,B,A,B]
        den = torch.where(den == 0, torch.ones_like(den), den)
        return torch.sum(diff / den[..., None, None]
                         * mask[..., None, None], dim=(2, 3))

    cd = repel(c, _pair_mask(M, D, c.device))
    # f is indexed [d, m]; its pair mask is the transposed layout
    fd = repel(f, _pair_mask(D, M, f.device))
    return cd, fd, _inverse_off_diagonal(b), _inverse_off_diagonal(p)


def diversity_loss(c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scalar form for autograd: ``½Σ log‖Δc‖² + Σ log|Δb|`` over the same
    restricted pair set — its gradient equals the repulsion gradients of
    :func:`diversity_gradients` for the kernels (the caller combines them as
    ``w0·g_recon − w1·g_div``, so the MINUS applies the repulsion)."""
    M, D = c.shape[0], c.shape[1]
    mask = _pair_mask(M, D, c.device)
    diff = c[:, :, None, None] - c[None, None, :, :]
    den = torch.sum(diff * diff, dim=(-2, -1))
    # identical kernels: log(0) -> -inf and NaN grads; guard like
    # diversity_gradients' den==0 path
    den = torch.where(den == 0, torch.ones_like(den), den)
    one = torch.ones_like(den)
    logs = torch.where(mask, torch.log(torch.where(mask, den, one)),
                       torch.zeros_like(den))
    bdiff = torch.abs(b[:, None] - b[None, :])
    off = ~torch.eye(M, dtype=torch.bool, device=b.device)
    blogs = torch.where(off, torch.log(torch.where(bdiff == 0,
                                                   torch.ones_like(bdiff),
                                                   bdiff)),
                        torch.zeros_like(bdiff))
    return 0.25 * torch.sum(logs) + 0.5 * torch.sum(blogs)


@tensor_cache
def _pair_weights(a: int, b: int, device: torch.device) -> torch.Tensor:
    """:func:`_pair_mask` of ``[A,B]`` kernels as an ``[A·B, A·B]`` float32
    matrix, kept on ``device``."""
    with torch.inference_mode(False):
        return _pair_mask(a, b, device).reshape(a * b, a * b).float()


def kernel_repulsion(c: torch.Tensor) -> torch.Tensor:
    """The kernels' half of :func:`diversity_gradients` for one stage,
    ``g_i = Σ_j w_ij·(k_i − k_j)`` with ``w_ij = mask_ij / ‖k_i − k_j‖²``,
    in the Gram form: ``‖k_i − k_j‖² = |k_i|² + |k_j|² − 2·k_i·k_j`` by one
    matrix product, then ``g_i = k_i·Σ_j w_ij − Σ_j w_ij·k_j`` by another.
    Two ``[A·B, A·B]`` float32 arrays (25 MB at 50 × 50) where the
    pairwise form builds ``[A,B,A,B,Nk,Nl]`` differences (625 MB).

    c: ``[A,B,Nk,Nl]``, any float type; the products run in IEEE float32
    (TF32 off) and the result is float32.

    Cancellation: the Gram distance carries an absolute error of about
    ``2ε·(|k_i|² + |k_j|²)`` (ε = 2⁻²⁴), so a pair's weight is off by that
    over ``‖k_i − k_j‖²`` relative: 1e-7 for kernels as far apart as they
    are long, and growing as ``|k|² / ‖k_i − k_j‖²`` where two kernels
    nearly coincide.  A pair whose distance lies within
    ``8ε·(|k_i|² + |k_j|²)`` of zero is taken as identical and adds
    nothing, as the pairwise form's zero difference does.
    """
    a, b = c.shape[0], c.shape[1]
    k = c.reshape(a * b, -1).float()
    with ieee_f32():
        sq = torch.sum(k * k, dim=1)
        norms = sq[:, None] + sq[None, :]
        den = torch.addmm(norms, k, k.T, alpha=-2.0)
        w = torch.where(den > 8 * torch.finfo(torch.float32).eps * norms,
                        _pair_weights(a, b, c.device) / den,
                        torch.zeros_like(den))
        g = torch.addmm(k * w.sum(dim=1, keepdim=True), w, k, alpha=-1.0)
    return g.reshape(c.shape)


def stage_diversity(c: torch.Tensor | None, b: torch.Tensor):
    """The repulsion gradients of one stage, ``(cd, bd)``: its kernels'
    (:func:`kernel_repulsion`; None where ``c`` is None, for a tied
    decoder stage, whose kernels' term is its encoder's transposed) and
    its biases' (``Σ_{j≠i} 1/(b_i − b_j)``).  The span ``diversity``."""
    with profiling.span("diversity"):
        cd = None if c is None else kernel_repulsion(c)
        return cd, _inverse_off_diagonal(b.float())
