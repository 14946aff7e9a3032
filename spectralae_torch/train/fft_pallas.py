"""Omega-space burst engines with the whole iteration in hand-written kernels.

Port of :mod:`spectralae.train.fft_pallas`.  The plain ω-space burst
(:func:`spectralae_torch.train.fft.fft_burst`) materialises, per iteration,
the gradient spectra ``dc/df [M, D, nx, nyr]`` and the kernel spectra.  But
every large intermediate is elementwise in ω or a rank-P DFT projection of
the 25-float kernels, so one sweep over the bins computes everything on
chip (:mod:`spectralae_torch.ops.burst_kernels`):

- :func:`burst_pallas_body`: per iteration K5 (the projected gradients from
  O), the inertia on the compact weights (plain tensor code, with the
  diversity term for ``maxdiff``), then K6 (the new O and its MSE);
- :func:`burst_pallas_fused`: one K5 for the first gradients, then one K7
  per iteration (K6 of iteration n fused with K5 of n+1);
- :func:`auto_burst`: the correlation-space burst for CUDA tensors, the
  plain ω-space burst for CPU ones.

CUDA tensors launch the kernels; CPU tensors run their plain versions.
``axis_name`` (the data axis's process group,
:mod:`spectralae_torch.dist.mesh`) makes either engine a data-parallel
burst over the batch shards: each iteration's gradients are pmean-ed
between the K5 (or K7) launch that made them and the update, in one
all_reduce, and the MSE trajectory once at the end.
``mxu_dtype=torch.bfloat16`` rounds the operands of the basis products to
bf16 with float32 sums.  The JAX ``interpret`` flag and its VMEM tile width
(``SPECTRALAE_PALLAS_TW``) have no counterpart: the CUDA kernels pick their
own tile.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..dist import collectives
from ..losses.losses import diversity_gradients
from ..ops import burst_kernels as bk
from ..ops import dft, spectral
from ..optim.update import burst_inertia
from .fft import FFTBurstResult, zero_moms


@functools.lru_cache(maxsize=4)  # the [2, P, W] basis is ~105 MB at 1024²
def _basis(nk: int, nl: int, nx: int, ny: int,
           device: torch.device) -> torch.Tensor:
    """Unweighted restricted-DFT basis ``[2, P, W]`` (cos, sin) float32 on
    ``device``: θ = 2π(rx·ωx/nx + ry·ωy/ny) at the circular kernel
    positions (see :mod:`spectralae_torch.ops.dft`)."""
    nyr = ny // 2 + 1
    rx = (np.arange(nk) - nk // 2) % nx
    ry = (np.arange(nl) - nl // 2) % ny
    theta = (2 * np.pi * np.outer(rx, np.arange(nx)) / nx)[:, None, :, None] \
        + (2 * np.pi * np.outer(ry, np.arange(nyr)) / ny)[None, :, None, :]
    theta = theta.reshape(nk * nl, nx * nyr)
    both = np.stack([np.cos(theta), np.sin(theta)]).astype(np.float32)
    with torch.inference_mode(False):
        return torch.as_tensor(both, device=device)


@functools.lru_cache(maxsize=None)
def _herm_weights(nx: int, ny: int, device: torch.device) -> torch.Tensor:
    """Per-bin Hermitian double-count weights ``[W]`` (the per-column
    :func:`spectralae_torch.ops.spectral._hermitian_weights`, tiled over
    the rows)."""
    w = np.tile(spectral._hermitian_weights(nx, ny), nx)
    with torch.inference_mode(False):
        return torch.as_tensor(w, device=device)


class _Burst(NamedTuple):
    """What every engine derives from its inputs."""
    nb: int
    nx: int
    ny: int
    md: int
    planes: torch.Tensor   # [6, nb·D, W]: X, Y, O₀ re/im
    Y: torch.Tensor
    O: torch.Tensor
    basis: torch.Tensor
    wv: torch.Tensor
    consts: dict           # norm, inv_m, inv_d, scale (the kernels' keywords)
    bf16: bool


def _check_mxu(mxu_dtype) -> bool:
    if mxu_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mxu_dtype must be torch.float32 or "
                        f"torch.bfloat16, not {mxu_dtype}")
    return mxu_dtype == torch.bfloat16


def _pmean_grads(g, gb, gp, axis_name):
    """The kernel's gradients, pmean-ed over the data axis when there is
    one (JAX: fft_pallas.py:286-287, :550-551)."""
    if axis_name is None:
        return g, gb, gp
    return tuple(collectives.pmean([g, gb, gp], axis_name))


def _pmean_mses(mses, axis_name):
    return mses if axis_name is None else collectives.pmean(mses, axis_name)


def _prepare(x, expout, out0, c, scale_by_dm, mxu_dtype) -> _Burst:
    bf16 = _check_mxu(mxu_dtype)
    if x.dim() == 3:
        x, expout, out0 = x[None], expout[None], out0[None]
    nb = x.shape[0]
    nx, ny = x.shape[-2], x.shape[-1]
    dM, dD, nk, nl = c.shape
    norm = float(nx * ny)
    n_norm = norm * 2.0 * dM * dD * nx * ny
    X, Y, O = (spectral.rfft2(t) for t in (x, expout, out0))
    w = nx * (ny // 2 + 1)
    planes = torch.stack([a.reshape(nb * dD, w) for Z in (X, Y, O)
                          for a in (Z.real, Z.imag)]).contiguous()
    consts = dict(norm=norm,
                  inv_m=(1.0 / dM) if scale_by_dm else 1.0,
                  inv_d=(1.0 / dD) if scale_by_dm else 1.0,
                  scale=1.0 / (n_norm * nb))
    return _Burst(nb, nx, ny, dM * dD, planes, Y, O,
                  _basis(nk, nl, nx, ny, x.device),
                  _herm_weights(nx, ny, x.device), consts, bf16)


def _mse_of(raw, c, nx, ny):
    """An MSE sum as the Parseval MSE: ``/ (D·N) / (2·M·N)`` (``calc_mse``
    and ``mse_fft``'s norm)."""
    dM, dD = c.shape[0], c.shape[1]
    return raw / (dD * nx * ny) / (2 * dM * nx * ny)


def _mses(s: _Burst, c, iters, dtype):
    """The trajectory, with entry 0 the batch-mean Parseval MSE of O₀."""
    dM, dD = c.shape[0], c.shape[1]
    mses = torch.zeros(iters + 1, dtype=dtype, device=s.planes.device)
    mses[0] = torch.mean(torch.stack([
        spectral.parseval_mse(a, o, dD, dM, s.nx, s.ny)
        for a, o in zip(s.Y, s.O)]))
    return mses


def _update(c, f, b, p, gc, gf, gb, gp, moms, del_eff, alpha, maxdiff, w0,
            w1):
    """The diversity combination (``maxdiff``), then the inertia on every
    weight; returns the weights and momenta."""
    if maxdiff:
        cd, fd, bd, pd = diversity_gradients(c, f, b, p)
        gc, gf = w0 * gc - w1 * cd, w0 * gf - w1 * fd
        gb, gp = w0 * gb - w1 * bd, w0 * gp - w1 * pd
    out = [burst_inertia(wt, g, mo, del_eff, alpha)
           for wt, g, mo in zip((c, f, b, p), (gc, gf, gb, gp), moms)]
    return [o[0] for o in out], tuple(o[1] for o in out)


def _stack(c, f, md, P):
    return torch.cat([c.reshape(md, P), f.reshape(md, P)])


@dft.ieee_f32()
def burst_pallas_body(x: torch.Tensor, expout: torch.Tensor,
                      out0: torch.Tensor, c: torch.Tensor, f: torch.Tensor,
                      b: torch.Tensor, p: torch.Tensor,
                      mom: tuple | None = None, *, lr: float = 0.2,
                      alpha: float = 0.9, iters: int = 100,
                      maxdiff: bool = False, w0: float = 1.0, w1: float = 10.0,
                      scale_by_dm: bool = True, axis_name=None,
                      mxu_dtype=torch.float32) -> FFTBurstResult:
    """Drop-in for :func:`spectralae_torch.train.fft.fft_burst`, two kernels
    an iteration (K5, then K6).

    ``x/expout/out0`` may be ``[D, h, w]`` (the reference burst) or
    ``[B, D, h, w]`` (batch-averaged gradients, ``fft_burst_dp``
    semantics).  The diversity term of ``maxdiff`` works on the compact
    kernels, between the two launches.  The MSE trajectory stays on the
    device until the loop ends.
    """
    s = _prepare(x, expout, out0, c, scale_by_dm, mxu_dtype)
    P = c.shape[-2] * c.shape[-1]
    k = s.consts
    moms = mom if mom is not None else zero_moms(c, f, b, p)
    mses = _mses(s, c, iters, x.dtype)
    planes = s.planes
    for i in range(iters):
        g, gb, gp = _pmean_grads(*bk.grad_project(
            planes, s.basis, s.wv, _stack(c, f, s.md, P), b, norm=k["norm"],
            scale=k["scale"], mxu_bf16=s.bf16), axis_name)
        (c, f, b, p), moms = _update(
            c, f, b, p, g[:s.md].reshape(c.shape), g[s.md:].reshape(f.shape),
            gb, gp, moms, 0.1 * lr, alpha, maxdiff, w0, w1)
        # O is written in place into the planes the next K5 reads
        _, msep = bk.respectra_conv(planes, s.basis, s.wv,
                                    _stack(c, f, s.md, P), b, p,
                                    norm=k["norm"], inv_m=k["inv_m"],
                                    inv_d=k["inv_d"], mxu_bf16=s.bf16,
                                    out=planes[4:])
        mses[i + 1] = _mse_of(msep, c, s.nx, s.ny)
    return FFTBurstResult(c=c, f=f, b=b, p=p, mom=moms,
                          mses=_pmean_mses(mses, axis_name))


# the JAX package jits the body under this name; PyTorch runs it eagerly
fft_burst_pallas = burst_pallas_body


@dft.ieee_f32()
def burst_pallas_fused(x, expout, out0, c, f, b, p, mom=None, *, lr=0.2,
                       alpha=0.9, iters=100, maxdiff=False, w0=1.0, w1=10.0,
                       scale_by_dm=True, axis_name=None,
                       mxu_dtype=torch.float32) -> FFTBurstResult:
    """Iteration-fused burst: one K5 on O₀, then one K7 per iteration (the
    forward of the updated weights and the next gradients in one sweep).
    Semantics identical to :func:`burst_pallas_body`."""
    s = _prepare(x, expout, out0, c, scale_by_dm, mxu_dtype)
    P = c.shape[-2] * c.shape[-1]
    k = s.consts
    moms = mom if mom is not None else zero_moms(c, f, b, p)
    mses = _mses(s, c, iters, x.dtype)
    g, gb, gp = bk.grad_project(s.planes, s.basis, s.wv,
                                _stack(c, f, s.md, P), b, norm=k["norm"],
                                scale=k["scale"], mxu_bf16=s.bf16)
    for i in range(iters):
        g, gb, gp = _pmean_grads(g, gb, gp, axis_name)
        (c, f, b, p), moms = _update(
            c, f, b, p, g[:s.md].reshape(c.shape), g[s.md:].reshape(f.shape),
            gb, gp, moms, 0.1 * lr, alpha, maxdiff, w0, w1)
        _, msep, g, gb, gp = bk.fused_step(
            s.planes, s.basis, s.wv, _stack(c, f, s.md, P), b, p,
            mxu_bf16=s.bf16, out=s.planes[4:], **k)
        mses[i + 1] = _mse_of(msep, c, s.nx, s.ny)
    return FFTBurstResult(c=c, f=f, b=b, p=p, mom=moms,
                          mses=_pmean_mses(mses, axis_name))


fft_burst_pallas_fused = burst_pallas_fused


def auto_burst(x, expout, out0, c, f, b, p, mom=None, *, lr=0.2, alpha=0.9,
               iters=100, maxdiff=False, w0=1.0, w1=10.0, scale_by_dm=True):
    """The burst for the tensors' device, as the JAX package routes it with
    ``x.is_cuda`` for ``_on_tpu()``: the correlation-space burst
    (:func:`spectralae_torch.train.fft_corr.fft_burst_corr`, re-anchored
    every 100 iterations beyond 100) for CUDA tensors; the plain ω-space
    burst for CPU ones, which trains against ``x`` when ``expout`` is
    None."""
    if x.is_cuda:
        from .fft_corr import fft_burst_corr
        return fft_burst_corr(
            x, expout, out0, c, f, b, p, mom, lr=lr, alpha=alpha,
            iters=iters, maxdiff=maxdiff, w0=w0, w1=w1,
            scale_by_dm=scale_by_dm,
            reanchor_every=100 if iters > 100 else None)
    from .fft import fft_burst
    if expout is None:
        expout = x  # the ω-space burst has no None handling
    return fft_burst(x, expout, out0, c, f, b, p, mom, lr=lr, alpha=alpha,
                     iters=iters, maxdiff=maxdiff, w0=w0, w1=w1,
                     scale_by_dm=scale_by_dm)
