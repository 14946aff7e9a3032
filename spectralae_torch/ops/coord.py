"""Coordinate-space ops: convolution (three reference tap windows) and pooling.

Port of :mod:`spectralae.ops.coord`.  The reference's hand-written CUDA
forward kernel (``conv_parallel``, source/backproplib.cu:70-111) and host
max-pool (source/netlib.cpp:114-164) become :func:`conv2d` — routed onto
the hand-written kernel K2 (:mod:`spectralae_torch.ops.coord_kernels`) for
tiny channel counts on the card, or ``torch.nn.functional.conv2d``
otherwise — and reshape-based pooling.  The reference's quirky *off-center*
tap windows are reproduced exactly via asymmetric padding (see
:func:`spectralae_torch.core.config.tap_anchor`).

All ops take batched ``[B, C, H, W]`` activations; the reference's
batch-of-one camera loop is the ``B=1`` special case.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._kernels import kernel_route
from ..core import profiling
from ..core.config import TapMode, tap_anchor
from .dft import ieee_f32


def _conv_padding(nk: int, nl: int,
                  mode: TapMode) -> tuple[tuple[int, int], tuple[int, int]]:
    """Asymmetric SAME padding implementing ``out[i] = Σ_k c[k]·in[i-(ik0+k)]``.

    With the kernel flipped, correlation gives
    ``out[i] = Σ_k c[Nk-1-k]·in[i + k - lo]``; choosing ``lo = ik0 + Nk - 1``
    reproduces the reference tap window for any anchor ``ik0``.
    """
    ik0 = tap_anchor(nk, mode)
    il0 = tap_anchor(nl, mode)
    lo_k = ik0 + nk - 1
    lo_l = il0 + nl - 1
    return (lo_k, nk - 1 - lo_k), (lo_l, nl - 1 - lo_l)


def _kernel_shape(c_shape) -> bool:
    """Whether :func:`conv2d` routes kernels of ``c_shape`` to K2 on the
    card: ``M·D ≤ 64`` and ``nk·nl ≤ 25``.

    The bounds are the JAX package's (``_auto_pallas_conv``, chosen on its
    accelerator); deciding the crossover against cuDNN on the card afresh is
    ROADMAP work.  Outside them the conv is ``F.conv2d``.
    """
    m, d, nk, nl = c_shape
    return m * d <= 64 and nk * nl <= 25


def _auto_conv_kernel(x: torch.Tensor, c_shape) -> bool:
    """Routing predicate for :func:`conv2d`: the hand-written kernel K2 for
    a :func:`_kernel_shape` on its route
    (:func:`~spectralae_torch._kernels.kernel_route`: CUDA tensors, or
    either device while ``torch.export`` traces)."""
    return kernel_route(x) and _kernel_shape(c_shape)


def conv2d(x: torch.Tensor, c: torch.Tensor, b: torch.Tensor | None = None,
           *, tap_mode: TapMode = "centered", scale_by_dm: bool = True,
           act=None, pallas: bool | None = None,
           m_global: int | None = None) -> torch.Tensor:
    """Reference-semantics 2-D convolution.

    Args:
      x: ``[B, D, H, W]`` input activations.
      c: ``[M, D, Nk, Nl]`` kernels (reference layout, netlib.cpp:246).
      b: ``[M]`` biases, added post-conv (backproplib.cu:107).
      tap_mode: which of the reference's tap windows to reproduce.
      scale_by_dm: pre-divide the input by the *output* depth M
        (backproplib.cu:134; the CPU reference ``Conv`` omits this).
      act: activation; ``None`` = identity (the reference's current ``act``,
        backproplib.cu:38-44).
      pallas: route through the hand-written valid-correlation kernel
        (:func:`spectralae_torch.ops.coord_kernels.conv_valid`; its plain
        version for CPU tensors) instead of ``F.conv2d``.  The name is the
        JAX package's.  ``None`` routes by :func:`_auto_conv_kernel`.
      m_global: the whole stage's M where ``c`` holds a slice of its
        output channels (the model axis,
        :mod:`spectralae_torch.dist.model_axis`).  It scales the input, as
        on one rank, and the route is decided on the whole stage's shape,
        as the JAX package's ``_auto_pallas_conv`` sees the unsharded one:
        a 10 → 10 stage takes cuDNN on every rank, though its [5, 10]
        slice would pass :func:`_kernel_shape`.  ``None``: ``c.shape[0]``.

    Reference: ``Conv`` netlib.cpp:318-358 (tap_mode='ref_cpu'),
    ``Conv_gpu``/``conv_parallel`` backproplib.cu:70-182 (tap_mode='ref_gpu').

    The span ``coord_conv``, its backward ``coord_conv.grad``; each call
    counts ``coord_conv.k2`` or ``coord_conv.cudnn`` by its route.
    """
    with profiling.span("coord_conv"):
        y = _conv2d(x, c, b, tap_mode, scale_by_dm, act, pallas, m_global)
    return profiling.grad_span("coord_conv.grad", y, x, c, b)


def _conv2d(x, c, b, tap_mode, scale_by_dm, act, pallas, m_global):
    shape = (m_global or c.shape[0],) + tuple(c.shape[1:])
    _, _, nk, nl = c.shape
    if scale_by_dm:
        x = x / shape[0]
    if tap_mode == "ref_cpu":
        # CPU boundary quirk: the bound check is `i-ik > 0` *strictly*
        # (netlib.cpp:344), so input row 0 / col 0 never contribute.
        x = x.clone()
        x[:, :, 0, :] = 0.0
        x[:, :, :, 0] = 0.0
    w = torch.flip(c, (-2, -1))  # flip: reference indexing is convolution-like
    (top, bottom), (left, right) = _conv_padding(nk, nl, tap_mode)
    xpad = F.pad(x, (left, right, top, bottom))
    if pallas is None:
        pallas = _auto_conv_kernel(x, shape)
    profiling.count("coord_conv.k2" if pallas else "coord_conv.cudnn")
    if pallas:
        from .coord_kernels import conv_valid
        # the kernel computes in float32; the stage keeps x's dtype
        y = conv_valid(xpad.contiguous(), w.contiguous()).to(x.dtype)
    else:
        with ieee_f32():   # cuDNN would run TF32 by default
            y = F.conv2d(xpad, w)
    if b is not None:
        y = y + b[None, :, None, None]
    if act is not None:
        y = act(y)
    return y


def max_pool(x: torch.Tensor, scale: int, *,
             quantize: bool = False) -> torch.Tensor:
    """Max-pool over ``scale×scale`` blocks, implicitly clamped at zero.

    The reference initializes the block max to 0 — and declares it ``int``
    (``int smax=0``, netlib.cpp:127), so each assignment truncates the
    float toward zero: the executed reference computes
    ``floor(max(0, block max))``.  ``quantize=True`` reproduces that
    exactly; the default keeps full precision — a documented quirk-fix.
    Reference: ``Pool`` with scale>0, netlib.cpp:117-140.
    """
    b, c, h, w = x.shape
    blocks = x.reshape(b, c, h // scale, scale, w // scale, scale)
    pooled = blocks.amax(dim=(3, 5))
    pooled = torch.clamp(pooled, min=0.0)
    if quantize:
        pooled = torch.floor(pooled)
    return pooled


def nn_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbor upsample by ``scale`` (reference: netlib.cpp:141-163)."""
    x = torch.repeat_interleave(x, scale, dim=-2)
    return torch.repeat_interleave(x, scale, dim=-1)


def pool(x: torch.Tensor, scale: int, *,
         quantize: bool = False) -> torch.Tensor:
    """Signed-scale pooling: ``scale>0`` downsample, ``scale<0`` upsample.

    Matches the reference's single ``Pool`` entry point (netlib.cpp:114);
    ``quantize`` selects the executed reference's integer-truncated
    downsample (see :func:`max_pool` — upsampling never truncates).  A
    resize is the span ``pool``, its backward ``pool.grad``.
    """
    if -1 <= scale <= 1:
        return x
    with profiling.span("pool"):
        out = (max_pool(x, scale, quantize=quantize) if scale > 1
               else nn_upsample(x, -scale))
    return profiling.grad_span("pool.grad", out, x)


def center_crop(x: torch.Tensor, q: int) -> torch.Tensor:
    """Center crop to ``(H/q, W/q)`` — the training patch ``Portion``.

    Reference: netlib.cpp:292-315 (random offset is commented out there too).
    """
    h, w = x.shape[-2], x.shape[-1]
    dh = (h - h // q) // 2
    dw = (w - w // q) // 2
    return x[..., dh:dh + h // q, dw:dw + w // q]


def leaky_relu(x: torch.Tensor, a: float = 0.01) -> torch.Tensor:
    """The reference's commented-out activation (backproplib.cu:38-51).

    The slope is rounded to ``x``'s dtype before the product, as JAX's
    weakly typed scalar is (bf16 forwards: 0.01 becomes 0.010009765625)."""
    return torch.where(x > 0, x, torch.tensor(a, dtype=x.dtype) * x)
