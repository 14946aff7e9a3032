"""Hand-written CUDA kernel for the coordinate-space conv (K2).

Counterpart of :mod:`spectralae.ops.pallas_conv`.  ``csrc/conv_valid.cu``
computes the valid correlation
``out[b,m,i,j] = Σ_{d,k,l} w[m,d,k,l]·xpad[b,d,i+k,j+l]`` for the tiny
channel counts of the reference net; the caller applies the tap-window
padding and the tap flip (:func:`spectralae_torch.ops.coord.conv2d`), as in
the JAX package.  The file's header note says what bounds it and why it is
shaped as it is.

:class:`ConvValid` carries the JAX package's custom VJP
(``_conv_valid_bwd``, pallas_conv.py:185-209): the data grad is a valid
correlation of the padded cotangent with the M/D-transposed, tap-flipped
weights — ``F.conv2d`` by default, or this kernel itself when
:data:`PALLAS_DATA_GRAD` is set — and the weight grad, a contraction over
pixels, is left to the library (cuDNN's backward-filter conv), as the JAX
package leaves it to ``lax``.

The kernel is the PyTorch operator ``spectralae_torch::conv_valid``
(:data:`conv_valid_op`, registered by
:func:`spectralae_torch._kernels.operator`), so a traced graph holds it as
one node.  Its CPU kernel is :func:`conv_valid_plain`, its CUDA kernel the
launch — never the plain version there.

bf16 operands are upcast to float32 in the wrapper, as
``conv_valid_pallas`` upcasts them (pallas_conv.py:150-151): the kernel
reads and returns float32, and the backward returns each gradient in its
operand's dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _kernels

#: route the data grad of :class:`ConvValid` through this kernel (True) or
#: through ``F.conv2d`` (False, the JAX package's default, chosen on its
#: accelerator; deciding it on the card is ROADMAP B6 work)
PALLAS_DATA_GRAD = False

NUM_SMS, _GRID_YZ, _cdiv = _kernels.NUM_SMS, _kernels.GRID_YZ, _kernels.cdiv
# the kernel's launch plan (csrc/conv_valid.cu): R output pixels a thread
# along j, _TILE_H threads (rows) along i, at most _MAX_GROUP output
# channels a thread; the largest dynamic shared memory one block may take
# on Hopper
_R, _TILE_H, _MAX_GROUP = 4, 8, 16
# warps an SM below which the output channels are split over the grid, and
# which the split aims for (the choice measured best at the train steps'
# shapes, scripts/torch_k1k2_bench.py --sweep)
_SPLIT_WARPS = 6
_MAX_SMEM = 232448


class K2Plan(NamedTuple):
    """One K2 launch: ``tx`` × ``ty`` threads a block (``tx`` along j, 4
    pixels each), ``mb`` output channels a thread, ``smem`` bytes of shared
    memory a block, and the grid (j tiles, i tiles, batch × channel
    groups)."""
    tx: int
    ty: int
    mb: int
    smem: int
    grid: tuple[int, int, int]


@functools.lru_cache(maxsize=512)
def k2_plan(b: int, d: int, m: int, hp: int, wp: int, nk: int,
            nl: int) -> K2Plan:
    """K2's launch plan for ``[B,D,Hp,Wp] × [M,D,nk,nl]`` from the shape
    alone.

    Tiles of 8 rows × 64 columns, or × 32 where those pad the output's
    width less (at most 32 wide, or 68, 132: a 64-wide tile would be
    nearly empty); each thread 4 adjacent pixels for ``mb`` output
    channels.  All channels (up to 16) stay in one thread while the grid
    has 6 warps an SM; a smaller grid splits them into the largest equal
    groups (``mb`` dividing M) that give it 6, or else into groups of two
    channels (one channel a thread measured slower).  Raises where no launch can run: the tile and the group's
    weights over a block's shared memory, or more row tiles or batch ×
    groups than the grid holds.
    """
    h, wo = hp - nk + 1, wp - nl + 1
    if min(b, d, m, nk, nl, h, wo) < 1:
        raise ValueError(f"k2_plan: B={b} D={d} M={m} {hp}x{wp} taps "
                         f"{nk}x{nl}")
    tx = 16 if _cdiv(wo, 64) * 64 <= _cdiv(wo, 32) * 32 else 8
    ty = _TILE_H
    # warps of the grid for each group of g channels a thread
    warps = _cdiv(wo, _R * tx) * _cdiv(h, ty) * b * tx * ty // 32
    mb = _cdiv(m, _cdiv(m, _MAX_GROUP))
    if warps * _cdiv(m, mb) < _SPLIT_WARPS * NUM_SMS:
        equal = [g for g in range(mb, 1, -1) if m % g == 0] or [mb]
        mb = next((g for g in equal
                   if warps * (m // g) >= _SPLIT_WARPS * NUM_SMS), equal[-1])
    groups = _cdiv(m, mb)
    cw = _cdiv(_R * tx + nl - 1, 4) * 4
    smem = 4 * (d * (ty + nk - 1) * cw + d * nk * nl * _cdiv(mb, 4) * 4)
    if smem > _MAX_SMEM:
        raise ValueError(f"conv_valid: {d} input channels of {nk}x{nl} taps "
                         f"need {smem} bytes of shared memory a block, over "
                         f"the {_MAX_SMEM} a block may take")
    if b * groups > _GRID_YZ or _cdiv(h, ty) > _GRID_YZ:
        raise ValueError(f"conv_valid: batch {b} x {groups} channel groups "
                         f"and {_cdiv(h, ty)} row tiles exceed the grid's "
                         f"limit of {_GRID_YZ}")
    return K2Plan(tx, ty, mb, smem, (_cdiv(wo, _R * tx), _cdiv(h, ty),
                                     b * groups))


# operand dtypes conv_valid takes; bf16 is upcast before the kernel
_DTYPES = (torch.float32, torch.bfloat16)


def conv_valid_plain(xpad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv_valid` (``F.conv2d`` is a correlation)."""
    return F.conv2d(xpad, w)


def _check_valid(xpad: torch.Tensor, w: torch.Tensor) -> None:
    if xpad.dim() != 4 or w.dim() != 4 or xpad.shape[1] != w.shape[1]:
        raise ValueError(f"xpad must be [B,D,Hp,Wp] and w [M,D,nk,nl], got "
                         f"{tuple(xpad.shape)} and {tuple(w.shape)}")
    if xpad.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"conv_valid takes float32 or bfloat16, got "
                        f"{xpad.dtype} and {w.dtype}")
    b, d, hp, wp = xpad.shape
    m, _, nk, nl = w.shape
    # `in`, not min(): see spectral_kernels._check_contract
    if 0 in (b, d, m, nk, nl) or hp < nk or wp < nl:
        raise ValueError(f"empty or too-small operands: xpad "
                         f"{tuple(xpad.shape)}, w {tuple(w.shape)}")
    if xpad.device != w.device:
        raise ValueError(f"xpad on {xpad.device}, w on {w.device}")
    if xpad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_valid runs on cpu or cuda, not {xpad.device}")


@_kernels.opaque
def _valid_corr(xpad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One valid correlation of float32 operands (checked by
    :func:`_check_valid`), through the operator (:data:`conv_valid_op`):
    the plain version for CPU tensors, a launch of the kernel for CUDA
    tensors."""
    return _conv_valid(xpad, w)


def _conv_valid_cpu(xpad, w):
    """The operator's CPU kernel: :func:`conv_valid_plain`."""
    return conv_valid_plain(xpad, w)


def _conv_valid_fake(xpad, w):
    return xpad.new_empty((xpad.shape[0], w.shape[0],
                           xpad.shape[2] - w.shape[2] + 1,
                           xpad.shape[3] - w.shape[3] + 1),
                          dtype=torch.float32)


def _conv_valid_cuda(xpad, w):
    """One launch of the kernel by :func:`k2_plan`."""
    if not (xpad.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv_valid needs contiguous operands")
    b, d, hp, wp = xpad.shape
    m, _, nk, nl = w.shape
    plan = k2_plan(b, d, m, hp, wp, nk, nl)
    # 16-byte staging loads where every row of xpad starts on 16 bytes
    vec = int(wp % 4 == 0 and xpad.data_ptr() % 16 == 0)
    out = torch.empty((b, m, hp - nk + 1, wp - nl + 1), dtype=torch.float32,
                      device=xpad.device)
    _kernels.launch("conv_valid_launch", "conv_valid", xpad.device,
                    xpad.data_ptr(), w.data_ptr(), out.data_ptr(), b, d, hp,
                    wp, m, nk, nl, plan.tx, plan.ty, plan.mb, vec)
    return out


#: K2's eager call on float32 ``[B,D,Hp,Wp] × [M,D,nk,nl]``
#: (:func:`spectralae_torch._kernels.operator`): its CPU kernel is
#: :func:`conv_valid_plain`, its CUDA kernel the launch, and its fake
#: version gives the ``[B, M, Hp-nk+1, Wp-nl+1]`` float32 result.
_conv_valid = _kernels.operator("conv_valid", "(Tensor xpad, Tensor w) -> "
                                "Tensor", _conv_valid_cpu, _conv_valid_cuda,
                                _conv_valid_fake)
#: K2 as a PyTorch operator, the node a traced graph records
conv_valid_op = _conv_valid.op


class ConvValid(torch.autograd.Function):
    """The valid correlation with the JAX package's custom VJP.

    The forward upcasts bf16 operands and returns float32; the backward
    works in float32 (the cotangent is float32, the operands may be bf16)
    and returns dx in ``xpad``'s dtype and dw in ``w``'s."""

    @staticmethod
    def forward(ctx, xpad, w):
        ctx.save_for_backward(xpad, w)
        return _valid_corr(xpad.float(), w.float())

    @staticmethod
    def backward(ctx, dy):
        xpad, w = ctx.saved_tensors
        _, _, nk, nl = w.shape
        dy = dy.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the same tap algebra as the forward: runnable through the
            # same kernel
            wt = w.float().transpose(0, 1).flip((-2, -1)).contiguous()
            dy_pad = F.pad(dy, (nl - 1, nl - 1, nk - 1, nk - 1))
            if PALLAS_DATA_GRAD:
                dx = _valid_corr(dy_pad.contiguous(), wt)
            else:
                dx = F.conv2d(dy_pad, wt)
            dx = dx.to(xpad.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(xpad.float(), w.shape,
                                             dy).to(w.dtype)
        return dx, dw


def conv_valid(xpad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid correlation ``[B,D,H+nk-1,W+nl-1] × [M,D,nk,nl] → [B,M,H,W]``,
    differentiable (:class:`ConvValid`).

    ``w`` holds the *already tap-flipped* correlation weights.  float32 or
    bfloat16 (upcast to float32; the result is float32); contiguous on the
    card.  Through the operator (:data:`conv_valid_op`): CPU tensors take
    :func:`conv_valid_plain`; CUDA tensors launch the kernel.
    """
    _check_valid(xpad, w)
    return ConvValid.apply(xpad, w)
