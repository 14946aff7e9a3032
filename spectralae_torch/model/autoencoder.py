"""The autoencoder model: mirrored encoder/decoder conv stages, two domains.

Port of :mod:`spectralae.model.autoencoder`.  The network is a *tape* of
conv stages (encoder half, then mirrored decoder half) with signed pooling
scales, exactly the reference's four parallel vectors
(source/autoencoder.cpp:109-120).  Forward passes:

- coordinate space: pool → conv (encoder), conv → unpool (decoder)
  (source/autoencoder.cpp:135-150);
- momentum space: one rfft2, per-stage spectral pool + pointwise complex
  conv, one irfft2 (``autoenc_fft``, source/fft_backproplib.cu:1331-1376).

Both are plain functions of ``(params, x)`` with the stage scales as
arguments; they run on whatever device ``params`` and ``x`` are on.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..core import profiling
from ..core.config import TapMode
from ..core.types import AEParams, ConvStage
from ..ops import coord, spectral


def tie_symmetric(params: AEParams, n_l: int) -> AEParams:
    """Copy ``cᵀ`` into the mirrored decoder stage ('p' key).

    ``f[d][m][k][l] = c[m][d][k][l]`` — note the spatial taps are *not*
    flipped (source/autoencoder.cpp:343-355).  Biases stay independent.
    """
    enc, dec = params.pair(n_l)
    dec = ConvStage(c=enc.c.transpose(0, 1), b=dec.b)
    return params.replace_pair(n_l, enc, dec)


def forward_coord(params: AEParams, x: torch.Tensor, scales: Sequence[int],
                  *, tap_mode: TapMode = "centered",
                  scale_by_dm: bool = True, act=None,
                  remat: bool = False,
                  stage_conv=None, sym: bool = False) -> list[torch.Tensor]:
    """Coordinate-space forward; returns the full activation tape.

    The returned list mirrors the reference ``layers`` vector: entry 0 is the
    input, then two entries per stage (encoder: pooled, conv-out; decoder:
    conv-out, unpooled), ``2·n_stages + 1`` entries total.  ``remat``
    checkpoints each conv (its padded input and intermediates are
    recomputed in the backward instead of saved).  ``stage_conv`` as in
    :func:`forward_fft`, with ``k`` the stage's taps ``c``.  ``sym``: each
    decoder stage convolves with its encoder's ``cᵀ`` (the 'p' tie) and
    its own ``c`` is not read.
    """
    n = params.n_stages

    def conv(h, c, b, **part):
        return coord.conv2d(h, c, b, tap_mode=tap_mode,
                            scale_by_dm=scale_by_dm, act=act, **part)

    def _stage(i, h, c, b):
        if stage_conv is not None:
            return stage_conv(i, h, c, b, conv)
        return conv(h, c, b)

    def stage_fn(i, h, c, b):
        if remat:
            return checkpoint(_stage, i, h, c, b, use_reentrant=False)
        return _stage(i, h, c, b)

    acts = [x]
    h = x
    for i, (stage, sc) in enumerate(zip(params.stages, scales)):
        if i < n // 2:  # encoder: pool then conv
            h = coord.pool(h, sc)
            acts.append(h)
            h = stage_fn(i, h, stage.c, stage.b)
            acts.append(h)
        else:  # decoder: conv then unpool
            c = params.stages[n - 1 - i].c.transpose(0, 1) if sym else stage.c
            h = stage_fn(i, h, c, stage.b)
            acts.append(h)
            h = coord.pool(h, sc)
            acts.append(h)
    return acts


def forward_fft(params: AEParams, x: torch.Tensor, scales: Sequence[int], *,
                scale_by_dm: bool = True,
                return_layers: bool = False,
                stage_conv=None, compute_dtype=None,
                remat: bool = False, sym: bool = False):
    """Momentum-space forward (reference ``autoenc_fft``).

    Args:
      x: ``[B, D, Nx, Ny]`` real input.
      return_layers: also inverse-transform every intermediate spectrum —
        the reference's ``fft_l`` per-layer visualization mode ('g' key,
        fft_backproplib.cu:1347-1361).
      stage_conv: optional hook ``stage_conv(i, X, k, b, conv)`` that runs
        stage ``i``'s conv in place of ``conv(X, k, b)``: ``k`` the stage's
        kernel spectra, ``conv(X, k, b, m_global=None)`` this forward's
        conv at the stage's grid, ``m_global`` the whole stage's output
        channels where ``k`` holds a slice of them.  The model axis
        (:mod:`spectralae_torch.dist.model_axis`) runs each stage on a
        rank's slice through it, where the JAX package's ``constrain``
        hook lays out the spectrum.
      compute_dtype: ``torch.bfloat16`` streams bf16 operands through the
        pointwise convs (float32 sums; the FFTs stay float32).
      remat: checkpoint each stage's kernel-spectrum + conv block — the
        kernel half-spectrum ``M·D·Nx·Nyr`` complex per stage, and the
        spectra the conv saves for its backward, are recomputed in the
        backward instead of kept.
      sym: the 'p' tie — each decoder stage's kernels are its encoder's
        transposed (``f = cᵀ``; the decoder's own ``c`` is not read).  A
        pair's two stages run on one grid, so the pair's spectrum is
        computed once, at the encoder stage, and the decoder reads it as
        its transposed view (no copy), which the counter
        ``kernel_spectra.shared`` counts; autograd sums both uses into
        the one spectrum's gradient, so its adjoint runs once a pair.
        With ``remat`` the spectrum is checkpointed with its encoder stage
        and kept for the decoder.

    Returns the ``[B, D, Nx, Ny]`` reconstruction, or ``(out, layers)``.
    """
    n = params.n_stages

    def _conv(Xs, C, b, i, cx, cy):
        def conv(Xs, C, b, **part):
            return spectral.spectral_conv(Xs, C, b, cx, cy,
                                          scale_by_dm=scale_by_dm,
                                          compute_dtype=compute_dtype,
                                          **part)
        if stage_conv is not None:
            return stage_conv(i, Xs, C, b, conv)
        return conv(Xs, C, b)

    def _stage(Xs, c, b, i, cx, cy, keep):
        # kernel spectra are recomputed per call — the functional
        # replacement for the reference's lazily-filled host-side
        # net_cfreq cache (fft_backproplib.cu:1146-1161)
        C = spectral.kernel_rfft(c, cx, cy)
        out = _conv(Xs, C, b, i, cx, cy)
        return (out, C) if keep else out

    nx, ny = x.shape[-2], x.shape[-1]
    X = spectral.rfft2(x)
    layers = [x]
    spectra = {}    # sym: each pair's spectrum, from encoder to decoder
    cx, cy = nx, ny
    for i, (stage, sc) in enumerate(zip(params.stages, scales)):
        if i < n // 2:
            X, cx, cy = spectral.spectral_pool(X, cx, cy, sc)
            if return_layers:
                layers.append(spectral.irfft2(X, (cx, cy)))
        if sym and i >= n // 2:
            C = spectra.pop(n - 1 - i).transpose(0, 1)
            profiling.count("kernel_spectra.shared")
            args = (X, C, stage.b, i, cx, cy)
            X = (checkpoint(_conv, *args, use_reentrant=False) if remat
                 else _conv(*args))
        else:
            args = (X, stage.c, stage.b, i, cx, cy, sym)
            X = (checkpoint(_stage, *args, use_reentrant=False) if remat
                 else _stage(*args))
            if sym:
                X, spectra[i] = X
        if return_layers:
            layers.append(spectral.irfft2(X, (cx, cy)))
        if i >= n // 2:
            X, cx, cy = spectral.spectral_pool(X, cx, cy, sc)
            if return_layers:
                layers.append(spectral.irfft2(X, (cx, cy)))
    out = spectral.irfft2(X, (cx, cy))
    if return_layers:
        layers[-1] = out
        return out, layers
    return out


def reconstruction_mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared reconstruction error (per element)."""
    return torch.mean((x - y) ** 2)


def encode(params: AEParams, x: torch.Tensor, scales: Sequence[int], *,
           domain: str = "fft", tap_mode: TapMode = "centered",
           scale_by_dm: bool = True) -> torch.Tensor:
    """Encoder-only inference: the bottleneck feature maps.

    A serving-path capability on top of the reference (which only exposes
    full reconstructions): runs the encoder half and returns the innermost
    ``[B, M, nx', ny']`` activations.
    """
    n = params.n_stages
    half = n // 2
    if domain == "fft":
        nx, ny = x.shape[-2], x.shape[-1]
        X = spectral.rfft2(x)
        cx, cy = nx, ny
        for stage, sc in zip(params.stages[:half], scales[:half]):
            X, cx, cy = spectral.spectral_pool(X, cx, cy, sc)
            C = spectral.kernel_rfft(stage.c, cx, cy)
            X = spectral.spectral_conv(X, C, stage.b, cx, cy,
                                       scale_by_dm=scale_by_dm)
        return spectral.irfft2(X, (cx, cy))
    h = x
    for stage, sc in zip(params.stages[:half], scales[:half]):
        h = coord.pool(h, sc)
        h = coord.conv2d(h, stage.c, stage.b, tap_mode=tap_mode,
                         scale_by_dm=scale_by_dm)
    return h
