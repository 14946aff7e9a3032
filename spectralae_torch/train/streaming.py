"""Streaming multi-burst training: K frames × an N-iteration burst each.

Port of :mod:`spectralae.train.streaming`.  The reference's steady-state
"training mode" is one 100-iteration burst per camera frame
(autoencoder.cpp:158-198 re-arms `sel` each loop; the burst is
source/fft_backproplib.cu:1381-1511).  Each frame of the stream

  1. re-anchors on the incoming frame — the anchor is the true two-stage
     forward with the CURRENT weights (what the interactive loop's
     per-frame forward provides as ``out0``, autoencoder.cpp:132 → 194),
     folded into the fused precompute (one K4 launch per frame on the card),
  2. runs the correlation-space burst (:mod:`spectralae_torch.train.fft_corr`),
  3. carries weights (and optionally momentum — the engine's
     ``--carry-momentum``) into the next frame.

The JAX package runs the frame loop as one ``lax.scan``; here it is a
Python loop over the frames, with weights and momentum carried on the
device and the MSE trajectories stacked at the end.  Equality:
``stream_bursts(xs)`` == the loop [forward → ``burst_corr`` → carry] over
``xs`` (:func:`stream_reference_loop`).

Coordinate-domain streaming (:func:`stream_coord_steps`) runs one
reference coord step per frame, with the full coordinate forward recomputed
from the current weights each frame (K2 twice a frame on the card, at the
3→10 and 10→3 stages of the default net).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.types import AEParams, ConvStage
from ..ops import dft
from .fft import FFTBurstResult, zero_moms
from .fft_corr import _true_forward, burst_corr


class StreamResult(NamedTuple):
    c: torch.Tensor
    f: torch.Tensor
    b: torch.Tensor
    p: torch.Tensor
    mom: tuple
    mses: torch.Tensor   # [K, iters+1] per-frame inner MSE trajectories


def _frames(xs: torch.Tensor) -> torch.Tensor:
    """``[K, D, h, w]`` → ``[K, 1, D, h, w]``; batched streams pass."""
    return xs[:, None] if xs.dim() == 4 else xs


def _burst_args(lr, alpha, iters, maxdiff, w0, w1, scale_by_dm,
                reanchor_every, axis_name, pallas_windows) -> dict:
    return dict(lr=lr, alpha=alpha, iters=iters, maxdiff=maxdiff, w0=w0,
                w1=w1, scale_by_dm=scale_by_dm, axis_name=axis_name,
                reanchor_every=reanchor_every, pallas_windows=pallas_windows)


@dft.ieee_f32()
def stream_bursts(xs: torch.Tensor, c: torch.Tensor, f: torch.Tensor,
                  b: torch.Tensor, p: torch.Tensor, mom: tuple | None = None,
                  *, lr: float = 0.2, alpha: float = 0.9, iters: int = 100,
                  maxdiff: bool = False, w0: float = 1.0, w1: float = 10.0,
                  scale_by_dm: bool = True, carry_momentum: bool = True,
                  reanchor_every: int | None = None,
                  axis_name=None,
                  pallas_windows=None) -> StreamResult:
    """Train through a stream of frames, one fused burst per frame.

    Args:
      xs: ``[K, D, h, w]`` frame stream, or ``[K, B, D, h, w]`` for a
        batched stream (each step batch-averages like ``fft_burst_dp``).
      carry_momentum: carry inertia state across frames (the reference
        carries dc/df across bursts while the layer selection is stable,
        autoencoder.cpp:279-310); ``False`` re-zeroes per frame.
      axis_name: the data axis's process group
        (:mod:`spectralae_torch.dist.mesh`): ``xs`` holds this rank's
        shard of every frame's batch, and each burst's correlation tensors
        are pmean-ed over the axis (one all_reduce a frame).
      pallas_windows: precompute routing for the per-frame fused burst
        (``burst_corr``) — ``"bf16"`` streams the signal spectra bf16
        through K4 (CLI ``--bf16``).

    Returns the final weights/momentum and the ``[K, iters+1]`` MSE
    trajectories (frame k's row is the reference's per-iteration
    ``mse fft:`` stream for that frame's burst).
    """
    kw = _burst_args(lr, alpha, iters, maxdiff, w0, w1, scale_by_dm,
                     reanchor_every, axis_name, pallas_windows)
    mo = mom if mom is not None else zero_moms(c, f, b, p)
    mses = []
    for xk in _frames(xs):
        mo_in = mo if carry_momentum else zero_moms(*mo)
        # out0=None: fused anchoring — the per-frame anchor forward is
        # folded into the precompute (no out0 FFT, no XG0 transforms)
        r = burst_corr(xk, None, None, c, f, b, p, mo_in, **kw)
        c, f, b, p, mo = r.c, r.f, r.b, r.p, r.mom
        mses.append(r.mses)
    return StreamResult(c=c, f=f, b=b, p=p, mom=mo, mses=torch.stack(mses))


#: the JAX package's jitted name for :func:`stream_bursts`
fft_stream = stream_bursts


def _pair_input(params: AEParams, xk: torch.Tensor, scales, n_l: int,
                scale_by_dm: bool = True) -> torch.Tensor:
    """Pooled input activation of stage pair ``n_l`` for a batch of frames
    — ``forward_fft(return_layers=True)`` layers ``[2·n_l+1]`` (the burst
    trainers' input contract), computed from only the stages it depends
    on: encoder stages ``0..n_l−1`` (through K1 on the card) plus the
    pair's own spectral pooling.  Those outer stages are frozen during a
    stream, so this is evaluated per frame."""
    from ..ops import spectral
    nx, ny = xk.shape[-2], xk.shape[-1]
    X = spectral.rfft2(xk)
    cx, cy = nx, ny
    for i in range(n_l):
        X, cx, cy = spectral.spectral_pool(X, cx, cy, scales[i])
        C = spectral.kernel_rfft(params.stages[i].c, cx, cy)
        X = spectral.spectral_conv(X, C, params.stages[i].b, cx, cy,
                                   scale_by_dm=scale_by_dm)
    X, cx, cy = spectral.spectral_pool(X, cx, cy, scales[n_l])
    return spectral.irfft2(X, (cx, cy))


@dft.ieee_f32()
def stream_bursts_pair(xs: torch.Tensor, params: AEParams, scales, n_l: int,
                       *, mom: tuple | None = None,
                       lr: float = 0.2, alpha: float = 0.9,
                       iters: int = 100, maxdiff: bool = False,
                       w0: float = 1.0, w1: float = 10.0,
                       scale_by_dm: bool = True,
                       carry_momentum: bool = True,
                       reanchor_every: int | None = None,
                       axis_name=None,
                       pallas_windows=None) -> StreamResult:
    """:func:`stream_bursts` for an *inner* stage pair of a deeper net.

    Each frame first computes the pair's pooled input activation from the
    frozen outer encoder stages (:func:`_pair_input` — the same activation
    burst mode trains on), then runs the fused-anchor burst on the pair.
    Returns the trained pair as a StreamResult (c/f/b/p of pair ``n_l``)."""
    kw = _burst_args(lr, alpha, iters, maxdiff, w0, w1, scale_by_dm,
                     reanchor_every, axis_name, pallas_windows)
    enc, dec = params.pair(n_l)
    c, f, b, p = enc.c, dec.c, enc.b, dec.b
    mo = mom if mom is not None else zero_moms(c, f, b, p)
    mses = []
    for xk in _frames(xs):
        in_b = _pair_input(params, xk, scales, n_l, scale_by_dm)
        mo_in = mo if carry_momentum else zero_moms(*mo)
        r = burst_corr(in_b, None, None, c, f, b, p, mo_in, **kw)
        c, f, b, p, mo = r.c, r.f, r.b, r.p, r.mom
        mses.append(r.mses)
    return StreamResult(c=c, f=f, b=b, p=p, mom=mo, mses=torch.stack(mses))


#: the JAX package's jitted name for :func:`stream_bursts_pair`
fft_stream_pair = stream_bursts_pair


class SweepResult(NamedTuple):
    params: AEParams        # every pair trained
    moms: tuple             # per-pair momentum tuples, pair order
    mses: torch.Tensor      # [K, n_pairs, iters+1] per-frame/per-pair MSEs


def _zero_moms(params: AEParams) -> tuple:
    return tuple(zero_moms(enc.c, dec.c, enc.b, dec.b)
                 for enc, dec in (params.pair(i)
                                  for i in range(params.n_pairs)))


@dft.ieee_f32()
def stream_bursts_sweep(xs: torch.Tensor, params: AEParams, scales, *,
                        moms: tuple | None = None,
                        lr: float = 0.2, alpha: float = 0.9,
                        iters: int = 100, maxdiff: bool = False,
                        w0: float = 1.0, w1: float = 10.0,
                        scale_by_dm: bool = True,
                        carry_momentum: bool = True,
                        reanchor_every: int | None = None,
                        axis_name=None,
                        pallas_windows=None) -> SweepResult:
    """Per-frame all-pairs sweep: each frame trains EVERY stage pair.

    The reference user's full-net training is the 'z'/'x' + '1'
    loop — select a pair, burst on the current frame, move on
    (autoencoder.cpp:279-310).  This function sweeps the pairs in order
    0..n_pairs−1 within each frame: pair ``n_l`` trains on its pooled
    activation computed through the outer encoder stages **already
    updated this frame** — the sequential keyboard sweep on a frozen frame.

    ``moms``: per-pair momentum tuples (pair order); zeros when None.
    """
    kw = _burst_args(lr, alpha, iters, maxdiff, w0, w1, scale_by_dm,
                     reanchor_every, axis_name, pallas_windows)
    mo = list(moms if moms is not None else _zero_moms(params))
    mses = []
    for xk in _frames(xs):
        mses_k = []
        for n_l in range(params.n_pairs):
            in_b = _pair_input(params, xk, scales, n_l, scale_by_dm)
            enc, dec = params.pair(n_l)
            mo_in = mo[n_l] if carry_momentum else zero_moms(*mo[n_l])
            r = burst_corr(in_b, None, None, enc.c, dec.c, enc.b, dec.b,
                           mo_in, **kw)
            params = params.replace_pair(n_l, ConvStage(c=r.c, b=r.b),
                                         ConvStage(c=r.f, b=r.p))
            mo[n_l] = r.mom
            mses_k.append(r.mses)
        mses.append(torch.stack(mses_k))
    return SweepResult(params=params, moms=tuple(mo), mses=torch.stack(mses))


#: the JAX package's jitted name for :func:`stream_bursts_sweep`
fft_stream_sweep = stream_bursts_sweep


class CoordStreamResult(NamedTuple):
    params: AEParams    # the selected pair trained
    mom: tuple          # (Dc, Df, Db, Dp)
    prev_grad: tuple    # adaptive-lr state
    mses: torch.Tensor  # [K] the per-frame coord mse


def stream_coord_steps(xs: torch.Tensor, params: AEParams, scales, n_l: int,
                       *, q: int = 1, lr: float = 0.2, alpha: float = 0.9,
                       tap_mode: str = "ref_gpu", sym: bool = False,
                       active: bool = False, scale_by_dm: bool = True,
                       mom: tuple | None = None,
                       prev_grad: tuple | None = None,
                       axis_name=None) -> CoordStreamResult:
    """Coordinate-domain streaming: one reference coord step per frame.

    The reference's coordinate training loop ('1' with fft off) is one
    ``backprop_gpu`` step per camera frame on the ``Portion``-cropped
    activations of the *current* full-net forward
    (autoencoder.cpp:131-188).  Each frame recomputes the full coordinate
    forward with the current weights (what ``Engine.step`` does before
    ``_train``), crops the pair's (input, output, hidden) triple by ``q``,
    and applies :func:`spectralae_torch.train.coord.coord_step_dp` —
    batched frames ``[K, B, D, h, w]`` use the batch-averaged gradients.

    Equality with the host loop [forward_coord → center_crop → coord_step
    → replace_pair] is held by the tests.  ``axis_name`` (the data axis's
    process group): ``xs`` holds this rank's shard of every frame's batch,
    and each step's gradients are pmean-ed over the axis.
    """
    from ..model import autoencoder as model
    from ..ops import coord as coord_ops
    from .coord import coord_step_dp
    enc, dec = params.pair(n_l)
    if mom is None:
        mom = zero_moms(enc.c, dec.c, enc.b, dec.b)
    if prev_grad is None:
        prev_grad = zero_moms(*mom)
    n_acts = 2 * params.n_stages + 1
    mses = []
    for xk in _frames(xs):
        acts = model.forward_coord(params, xk, scales, tap_mode=tap_mode,
                                   scale_by_dm=scale_by_dm)
        in_b = coord_ops.center_crop(acts[2 * n_l + 1], q)
        hin_b = coord_ops.center_crop(acts[2 * n_l + 2], q)
        out_b = coord_ops.center_crop(acts[n_acts - 2 - 2 * n_l], q)
        enc, dec = params.pair(n_l)
        r = coord_step_dp(in_b, out_b, hin_b, enc.c, dec.c, enc.b, dec.b,
                          mom, prev_grad, lr=lr, alpha=alpha,
                          tap_mode=tap_mode, sym=sym, active=active,
                          axis_name=axis_name)
        params = params.replace_pair(n_l, ConvStage(c=r.c, b=r.b),
                                     ConvStage(c=r.f, b=r.p))
        mom, prev_grad = r.mom, r.prev_grad
        mses.append(r.mse)
    return CoordStreamResult(params=params, mom=mom, prev_grad=prev_grad,
                             mses=torch.stack(mses))


#: the JAX package's jitted name for :func:`stream_coord_steps`
coord_stream = stream_coord_steps


@dft.ieee_f32()
def stream_reference_loop(xs, c, f, b, p, mom=None, *, lr=0.2, alpha=0.9,
                          iters=100, maxdiff=False, w0=1.0, w1=10.0,
                          scale_by_dm=True, carry_momentum=True,
                          reanchor_every=None) -> StreamResult:
    """The same stream as K sequential bursts, each anchored on an
    explicit pixel-space forward — the equality oracle for
    :func:`stream_bursts`."""
    mses = []
    r = FFTBurstResult(c=c, f=f, b=b, p=p,
                       mom=mom if mom is not None else zero_moms(c, f, b, p),
                       mses=None)
    for xk in _frames(xs):
        out0 = _true_forward(xk, r.c, r.f, r.b, r.p, scale_by_dm)
        mo_in = r.mom if carry_momentum else zero_moms(*r.mom)
        r = burst_corr(xk, None, out0, r.c, r.f, r.b, r.p, mo_in,
                       lr=lr, alpha=alpha, iters=iters, maxdiff=maxdiff,
                       w0=w0, w1=w1, scale_by_dm=scale_by_dm,
                       reanchor_every=reanchor_every)
        mses.append(r.mses)
    return StreamResult(c=r.c, f=r.f, b=r.b, p=r.p, mom=r.mom,
                        mses=torch.stack(mses))
