"""Hand-written CUDA kernel for the coordinate-space conv (K2).

Counterpart of :mod:`spectralae.ops.pallas_conv`.  ``csrc/conv_valid.cu``
computes the valid correlation
``out[b,m,i,j] = Σ_{d,k,l} w[m,d,k,l]·xpad[b,d,i+k,j+l]`` for the tiny
channel counts of the reference net; the caller applies the tap-window
padding and the tap flip (:func:`spectralae_torch.ops.coord.conv2d`), as in
the JAX package.  The file's header note says what bounds it and why it is
shaped as it is.

:func:`conv_valid` runs :func:`conv_valid_plain` for CPU tensors and
launches the kernel for CUDA tensors — never the plain version there.
:data:`LAUNCHES` counts kernel launches.  Forward only: the backward is
ROADMAP queue B work ("B6 VJP").
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _kernels
from .spectral_kernels import _check_no_grad

#: kernel launches of :func:`conv_valid` since import (or the last reset)
LAUNCHES = 0

# the kernel's output tile (csrc/conv_valid.cu kTileH x kTileW) and the
# largest dynamic shared memory one block may take on Hopper
_TILE_H, _TILE_W = 8, 32
_MAX_SMEM = 232448


def conv_valid_plain(xpad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv_valid` (``F.conv2d`` is a correlation)."""
    return F.conv2d(xpad, w)


def conv_valid(xpad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid correlation ``[B,D,H+nk-1,W+nl-1] × [M,D,nk,nl] → [B,M,H,W]``.

    ``w`` holds the *already tap-flipped* correlation weights.  float32,
    contiguous.  CPU tensors take :func:`conv_valid_plain`; CUDA tensors
    launch the kernel.
    """
    global LAUNCHES
    if xpad.dim() != 4 or w.dim() != 4 or xpad.shape[1] != w.shape[1]:
        raise ValueError(f"xpad must be [B,D,Hp,Wp] and w [M,D,nk,nl], got "
                         f"{tuple(xpad.shape)} and {tuple(w.shape)}")
    if xpad.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv_valid takes float32, got {xpad.dtype} and "
                        f"{w.dtype}")
    b, d, hp, wp = xpad.shape
    m, _, nk, nl = w.shape
    if min(b, d, m, nk, nl) == 0 or hp < nk or wp < nl:
        raise ValueError(f"empty or too-small operands: xpad "
                         f"{tuple(xpad.shape)}, w {tuple(w.shape)}")
    if xpad.device != w.device:
        raise ValueError(f"xpad on {xpad.device}, w on {w.device}")
    if xpad.device.type == "cpu":
        return conv_valid_plain(xpad, w)
    if xpad.device.type != "cuda":
        raise ValueError(f"conv_valid runs on cpu or cuda, not {xpad.device}")
    _check_no_grad("conv_valid", xpad, w)
    if not (xpad.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv_valid needs contiguous operands")
    if b > 65535:
        raise ValueError(f"conv_valid: batch {b} exceeds the grid's z limit "
                         "of 65535")
    smem = 4 * (d * (_TILE_H + nk - 1) * (_TILE_W + nl - 1) + m * d * nk * nl)
    if smem > _MAX_SMEM:
        raise ValueError(f"conv_valid: {d} input channels of {nk}x{nl} taps "
                         f"and {m * d * nk * nl} weights need {smem} bytes "
                         f"of shared memory, over the {_MAX_SMEM} a block "
                         "may take")
    out = torch.empty((b, m, hp - nk + 1, wp - nl + 1), dtype=torch.float32,
                      device=xpad.device)
    with torch.cuda.device(xpad.device):
        err = _kernels.lib().conv_valid_launch(
            xpad.data_ptr(), w.data_ptr(), out.data_ptr(), b, d, hp, wp, m,
            nk, nl, torch.cuda.current_stream().cuda_stream)
    _kernels.check(err, "conv_valid")
    LAUNCHES += 1
    return out
