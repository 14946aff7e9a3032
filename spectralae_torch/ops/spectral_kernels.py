"""Hand-written CUDA kernel for the momentum-space conv (K1).

Counterpart of :mod:`spectralae.ops.pallas_kernels`.  The reference's hot
device kernel is the pointwise complex-multiply convolution ``conv_k``
(source/fft_backproplib.cu:162-189); here it is ``csrc/cmul_contract.cu``,
a per-bin complex contraction that reads complex64 as interleaved
``float2`` and fuses the ``1/M`` input scale and the DC-bin bias into its
one pass.  The file's header note says what bounds it and why it is shaped
as it is.

:class:`SpectralConvFused` carries the JAX package's custom VJP: its
backward is two more launches of the same kernel, one for the input spectra
and one for the kernel spectra, with ``q`` conjugated (PyTorch's gradient of
a complex-linear map is the conjugate of JAX's cotangent).

The kernel is the PyTorch operator ``spectralae_torch::cmul_contract``
(:func:`cmul_contract_op`, made with ``torch.library.custom_op``), so a
traced graph (``torch.export``, ``torch.compile``) holds it as one node;
eager code calls the operator's kernel for its device directly
(:func:`spectralae_torch.ops.dft.call_operator`).  Its CPU kernel is the
plain PyTorch version; its CUDA kernel launches the hand-written kernel —
never the plain version, and never a library kernel in its place.  :data:`LAUNCHES` counts kernel launches with complex64
operands, :data:`LAUNCHES_BF16` those with bf16 operands.

``compute_dtype=torch.bfloat16`` is the JAX package's mixed-precision path
(``_conv_fwd_impl``/``_conv_bwd``, pallas_kernels.py:100-151): every
contraction reads bf16 operands — :func:`bf16_planes`, each complex bin as
an interleaved (re, im) bf16 pair — and sums in float32 into complex64.
The operands are rounded where JAX rounds them: ``X/M`` (not ``X``) in the
forward and in the kernel-spectrum gradient; in the input-spectrum gradient
JAX rounds ``g`` and scales the float32 sum, which the kernel's ``p_scale``
does to float32 rounding.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import _kernels
from .dft import call_operator

#: kernel launches of :func:`cmul_contract` since import (or the last
#: reset): complex64 operands, and bf16 operands (the second instantiation)
LAUNCHES = 0
LAUNCHES_BF16 = 0

NUM_SMS, _GRID_YZ, _cdiv = _kernels.NUM_SMS, _kernels.GRID_YZ, _kernels.cdiv
# K1's launch plan (csrc/cmul_contract.cu): a warp's 32 lanes along the
# bins, at most 8 channel warps a block; rows ``a`` are chunked as long as
# the grid keeps _K1_THREADS threads, at most _K1_MAX_ROWS rows a thread;
# a grid of _K1_MANY_BLOCKS blocks or more takes small channel groups (the
# choices measured best at the train steps' shapes,
# scripts/torch_k1k2_bench.py)
_K1_LANES, _K1_MAX_GROUP, _K1_MAX_ROWS = 32, 8, 4
_K1_THREADS = NUM_SMS * 384
_K1_MANY_BLOCKS = NUM_SMS * 8


class K1Plan(NamedTuple):
    """One K1 launch: ``vec`` bins a lane (1, or one 16-byte vector: 2
    complex64 bins, 4 bf16 pairs), ``group`` channel warps a block,
    ``rows`` rows ``a`` a thread, and the grid (bin tiles, channel
    groups, row chunks)."""
    vec: int
    group: int
    rows: int
    grid: tuple[int, int, int]


def k1_vec(w: int, strides, ptrs, wide: int) -> int:
    """Bins a lane of K1: ``wide`` (one 16-byte vector: 2 for complex64, 4
    for bf16 pairs) where every row of p and q and of the output starts on
    a vector — W and the four strides (in complex elements) multiples of
    it, p and q (``ptrs``, their addresses) on 16 bytes — else 1."""
    return wide if (w % wide == 0 and all(s % wide == 0 for s in strides)
                    and all(ptr % 16 == 0 for ptr in ptrs)) else 1


@functools.lru_cache(maxsize=512)
def k1_plan(a: int, k: int, b: int, w: int, vec: int) -> K1Plan:
    """K1's launch plan for ``[A,K,W] × [K,B,W] → [A,B,W]`` from the shape
    alone (``vec``: the widest vector the operands' layout allows).

    One thread computes one output channel at ``vec`` bins for a chunk of
    up to 4 rows, holding ``q`` for every ``k`` in registers, so a chunk
    reads ``q`` once.  Rows are split into as few equal chunks as keep 384
    threads an SM (one row a thread if none do).  The channels go in equal
    groups of warps: as large as B allows up to 8, so that the warps of a
    block share each ``p`` vector through L1, unless that grid already
    has 8 blocks an SM, where the smallest groups (2, or B's smallest
    factor) measured faster.  ``A`` is unbounded: a thread takes as many
    rows as keeps the chunks within the grid's z limit.  ``K`` does not
    change the plan (the kernel unrolls it).
    """
    if min(a, k, b, w) < 1 or vec not in (1, 2, 4):
        raise ValueError(f"k1_plan: A={a} K={k} B={b} W={w} vec={vec}")
    tiles = _cdiv(w, _K1_LANES * vec)
    per_chunk = tiles * _K1_LANES * b          # threads a chunk of rows
    rows = next((r for r in (_cdiv(a, n) for n in range(
        _cdiv(a, _K1_MAX_ROWS), a + 1))
        if per_chunk * _cdiv(a, r) >= _K1_THREADS), 1)
    rows = max(rows, _cdiv(a, _GRID_YZ))
    factors = [g for g in range(1, min(b, _K1_MAX_GROUP) + 1) if b % g == 0]
    group = factors[-1]
    if tiles * (b // group) * _cdiv(a, rows) >= _K1_MANY_BLOCKS:
        group = factors[min(1, len(factors) - 1)]
    groups = b // group
    if groups > _GRID_YZ:
        raise ValueError(f"cmul_contract: B={b} output channels need "
                         f"{groups} channel groups, over the grid's y limit "
                         f"of {_GRID_YZ}")
    return K1Plan(vec, group, rows, (tiles, groups, _cdiv(a, rows)))


def bf16_planes(z: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """A complex64 tensor ``[..., W]`` times ``scale`` (in float32, before
    the rounding), rounded to bf16 as K1's bf16 operands: ``[..., W, 2]``
    interleaved (re, im), 4 bytes a bin."""
    t = torch.view_as_real(z)
    return (t if scale == 1.0 else t * scale).to(torch.bfloat16)


def _complex(planes: torch.Tensor) -> torch.Tensor:
    """bf16 planes ``[..., W, 2]`` back to complex64 ``[..., W]`` (exact)."""
    return torch.complex(planes[..., 0].float(), planes[..., 1].float())


def cmul_contract_plain(p: torch.Tensor, q: torch.Tensor, *,
                        p_scale: float = 1.0, conj_q: bool = False,
                        bias: torch.Tensor | None = None,
                        bias_scale: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`cmul_contract`: the same math as einsum.

    ``out[a,b,w] = Σ_k (p_scale·p[a,k,w])·q'[k,b,w]`` with
    ``q' = conj(q)`` when ``conj_q``, plus ``bias[b]·bias_scale`` on bin
    ``w = 0`` when ``bias`` is given.  bf16 planes (:func:`bf16_planes`)
    are converted back to complex64, exactly, and contracted in float32.
    """
    if p.dtype == torch.bfloat16:
        p, q = _complex(p), _complex(q)
    if conj_q:
        q = q.conj()
    out = torch.einsum("akw,kbw->abw", p * p_scale, q)
    if bias is not None:
        # the einsum result is fresh, so the DC add may update it in place
        out[:, :, 0] += (bias * bias_scale).to(out.dtype)
    return out


def _check_contract(p, q, bias) -> None:
    if p.dtype != q.dtype or p.dtype not in (torch.complex64,
                                             torch.bfloat16):
        raise TypeError(f"cmul_contract takes complex64, or bf16 planes "
                        f"[..., W, 2], both alike; got {p.dtype} and "
                        f"{q.dtype}")
    if p.dtype == torch.bfloat16:
        if p.dim() != 4 or q.dim() != 4 or p.shape[3] != 2 or \
                q.shape[3] != 2:
            raise ValueError(f"bf16 planes must be [A,K,W,2] and [K,B,W,2], "
                             f"got {tuple(p.shape)} and {tuple(q.shape)}")
        p, q = p[..., 0], q[..., 0]
    if p.dim() != 3 or q.dim() != 3:
        raise ValueError(f"p must be [A,K,W] and q [K,B,W], got "
                         f"{tuple(p.shape)} and {tuple(q.shape)}")
    if p.shape[1] != q.shape[0] or p.shape[2] != q.shape[2]:
        raise ValueError(f"shape mismatch: p {tuple(p.shape)}, "
                         f"q {tuple(q.shape)}")
    # `in`, not min(): a symbolic batch under torch.export compares equal
    # to 0 statically, where min() would guard it against the other sizes
    if 0 in p.shape or q.shape[1] == 0:
        raise ValueError("cmul_contract needs non-empty operands")
    if p.device != q.device:
        raise ValueError(f"p on {p.device}, q on {q.device}")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cmul_contract runs on cpu or cuda, not {p.device}")
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.shape != (q.shape[1],)
                or bias.device != p.device):
            raise ValueError(f"bias must be float32 [{q.shape[1]}] on "
                             f"{p.device}, got {bias.dtype} "
                             f"{tuple(bias.shape)} on {bias.device}")


@_kernels.opaque
def cmul_contract(p: torch.Tensor, q: torch.Tensor, *,
                  p_scale: float = 1.0, conj_q: bool = False,
                  bias: torch.Tensor | None = None,
                  bias_scale: float = 0.0) -> torch.Tensor:
    """Per-bin complex contraction ``[A,K,W] × [K,B,W] → [A,B,W]`` (K1).

    ``p`` and ``q`` are complex64, or both bf16 planes ``[A,K,W,2]`` and
    ``[K,B,W,2]`` (:func:`bf16_planes`; products and sums stay float32, the
    output complex64).  They may be any views whose bins are contiguous:
    the spectral conv passes its ``[M, D, W]`` kernel spectra transposed,
    and its backward the ``[B, M, W]`` cotangent transposed, with no copy.
    ``conj_q`` contracts with ``conj(q)``.  Checks the operands and calls
    the operator ``spectralae_torch::cmul_contract``
    (:func:`cmul_contract_op`, through
    :func:`~spectralae_torch.ops.dft.call_operator`): CPU tensors take
    :func:`cmul_contract_plain`, CUDA tensors launch the kernel.  The
    result carries no gradient: :class:`SpectralConvFused` does.
    """
    _check_contract(p, q, bias)
    return call_operator(cmul_contract_op, _CMUL_CONTRACT_KERNELS, p, q,
                         float(p_scale), bool(conj_q), bias,
                         float(bias_scale))


def _cmul_contract_cpu(p, q, p_scale, conj_q, bias, bias_scale):
    """The operator's CPU kernel: :func:`cmul_contract_plain`."""
    # contiguous, as the kernel writes it (the einsum may permute it)
    return cmul_contract_plain(p, q, p_scale=p_scale, conj_q=conj_q,
                               bias=bias, bias_scale=bias_scale).contiguous()


def _cmul_contract_fake(p, q, p_scale, conj_q, bias, bias_scale):
    return p.new_empty((p.shape[0], q.shape[1], p.shape[2]),
                       dtype=torch.complex64)


def _cmul_contract_cuda(p, q, p_scale, conj_q, bias, bias_scale):
    """One launch of the kernel: the operands' layout checked, the launch
    plan (:func:`k1_vec`, :func:`k1_plan`) chosen from their strides and
    addresses, and the launch counted."""
    global LAUNCHES, LAUNCHES_BF16
    if p.dtype == torch.bfloat16:
        # strides in (re, im) pairs, the kernel's element
        if p.stride(3) != 1 or q.stride(3) != 1 or p.stride(2) != 2 \
                or q.stride(2) != 2 or any(
                    t.stride(i) % 2 or t.data_ptr() % 4
                    for t in (p, q) for i in (0, 1)):
            raise ValueError("cmul_contract needs bf16 planes whose "
                             "(re, im) pairs are contiguous and aligned")
        strides = (p.stride(0) // 2, p.stride(1) // 2, q.stride(0) // 2,
                   q.stride(1) // 2)
        launch, wide = _kernels.lib().cmul_contract_bf16_launch, 4
    else:
        # a lazily conjugated or negated view flags its storage but does
        # not change it, and the kernel reads the storage: materialise it
        p = p.resolve_conj().resolve_neg()
        q = q.resolve_conj().resolve_neg()
        if p.stride(2) != 1 or q.stride(2) != 1:
            raise ValueError("cmul_contract needs p and q whose last axis "
                             "is contiguous")
        strides = (p.stride(0), p.stride(1), q.stride(0), q.stride(1))
        launch, wide = _kernels.lib().cmul_contract_launch, 2
    if bias is not None and not bias.is_contiguous():
        raise ValueError("bias must be contiguous")
    a, k, w = p.shape[:3]
    b = q.shape[1]
    plan = k1_plan(a, k, b, w, k1_vec(w, strides,
                                      (p.data_ptr(), q.data_ptr()), wide))
    out = torch.empty((a, b, w), dtype=torch.complex64, device=p.device)
    with torch.cuda.device(p.device):
        err = launch(
            p.data_ptr(), q.data_ptr(), out.data_ptr(), a, k, b, w,
            *strides, int(conj_q), float(p_scale),
            None if bias is None else bias.data_ptr(), float(bias_scale),
            plan.vec, plan.group, plan.rows,
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(err, "cmul_contract")
    if p.dtype == torch.bfloat16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return out


#: K1 as a PyTorch operator, the node a traced graph records: its CPU
#: kernel is :func:`cmul_contract_plain`, its CUDA kernel the launch, and
#: its fake version gives the ``[A, B, W]`` complex64 result of either
#: operand type.  Call it through :func:`cmul_contract`, which checks the
#: operands.
cmul_contract_op = torch.library.custom_op(
    "spectralae_torch::cmul_contract", _cmul_contract_cpu, mutates_args=(),
    device_types="cpu",
    schema="(Tensor p, Tensor q, float p_scale, bool conj_q, Tensor? bias, "
           "float bias_scale) -> Tensor")
cmul_contract_op.register_kernel("cuda", _cmul_contract_cuda)
cmul_contract_op.register_fake(_cmul_contract_fake)
_CMUL_CONTRACT_KERNELS = {"cpu": _cmul_contract_cpu,
                          "cuda": _cmul_contract_cuda}


def check_compute_dtype(compute_dtype) -> None:
    """The operand types the port streams: float32 (``None``) or bf16."""
    if compute_dtype not in (None, torch.bfloat16):
        raise NotImplementedError(
            f"compute_dtype={compute_dtype}: the port streams bf16 operands "
            "only (torch.bfloat16, the JAX package's B1 bf16 mode) or "
            "float32 (None)")


class SpectralConvFused(torch.autograd.Function):
    """The spectral conv with the JAX package's custom VJP (``_conv_bwd``,
    pallas_kernels.py:123-151), every contraction through K1.

    Forward: ``out[b,m] = Σ_d (X[b,d]/M)·C[m,d]`` + ``b[m]·Nx·Ny`` on the
    DC bin.  Backward, in PyTorch's conjugate convention:
    ``dX[b,d] = Σ_m g[b,m]·conj(C[m,d])/M`` (``p = g``, ``q = C``) and
    ``dC[m,d] = Σ_b g[b,m]·conj(X[b,d])/M`` (``p = gᵀ``, a view, and
    ``q = X``); ``db[m] = Nx·Ny·Re Σ_b g[b,m,0,0]``.  A gradient that no
    input needs is not computed, so stage 0 of a net (whose input spectra
    come from the frames) launches K1 once in its backward, not twice.

    With ``compute_dtype=torch.bfloat16`` each contraction reads bf16
    operands, rounded where JAX rounds them: ``X/M`` and ``C`` in the
    forward, ``g`` and ``C`` for dX (the ``1/M`` applied in float32 by the
    kernel), ``gᵀ`` and ``X/M`` for dC.  ``X`` and ``C`` are saved in
    complex64 and rounded again in the backward, as ``_conv_bwd`` does.

    A part of the whole conv (the model axis,
    :mod:`spectralae_torch.dist.model_axis`): ``m_global`` is the whole
    stage's M where ``C`` holds a slice of its output channels (the scale
    stays ``1/M``; every launch runs at the local shape), and ``b=None``
    adds no bias (a slab of grid rows without row 0).  ``X`` and
    ``C`` may hold a slab of the grid's rows: the bins are read off their
    shape, and ``nx·ny``, the bias's scale, is the whole grid's.
    """

    @staticmethod
    def forward(ctx, X, C, b, nx, ny, scale_by_dm, compute_dtype,
                m_global=None):
        nb, d = X.shape[0], X.shape[1]
        m = C.shape[0]
        rows, cols = X.shape[-2], X.shape[-1]
        w = rows * cols
        scale = (1.0 / (m_global or m)) if scale_by_dm else 1.0
        Cw = C.reshape(m, d, w)
        if compute_dtype is None:
            p, q, p_scale = X.reshape(nb, d, w), Cw.transpose(0, 1), scale
        else:
            # JAX rounds X·(1/M), not X: scale before the cast
            p = bf16_planes(X.reshape(nb, d, w), scale)
            q, p_scale = bf16_planes(Cw).transpose(0, 1), 1.0
        out = cmul_contract(p, q, p_scale=p_scale,   # q: [D, M, W] view
                            bias=None if b is None else
                            b.to(torch.float32).contiguous(),
                            bias_scale=float(nx * ny))
        ctx.save_for_backward(X, C)
        ctx.dims = (nb, d, m, w, nx * ny, scale,
                    None if b is None else b.dtype, compute_dtype)
        return out.reshape(nb, m, rows, cols)

    @staticmethod
    def backward(ctx, g):
        X, C = ctx.saved_tensors
        nb, d, m, w, n_pix, scale, b_dtype, compute_dtype = ctx.dims
        g = g.resolve_conj().resolve_neg().reshape(nb, m, w).contiguous()
        gp = g if compute_dtype is None else bf16_planes(g)
        dX = dC = db = None
        if ctx.needs_input_grad[0]:
            Cw = C.reshape(m, d, w)
            q = Cw if compute_dtype is None else bf16_planes(Cw)
            dX = cmul_contract(gp, q, p_scale=scale,
                               conj_q=True).reshape(X.shape)
        if ctx.needs_input_grad[1]:
            Xw = X.reshape(nb, d, w)
            if compute_dtype is None:
                q, p_scale = Xw, scale
            else:
                q, p_scale = bf16_planes(Xw, scale), 1.0
            dC = cmul_contract(gp.transpose(0, 1), q, p_scale=p_scale,
                               conj_q=True).reshape(C.shape)
        if ctx.needs_input_grad[2]:
            db = (g[:, :, 0].real.sum(dim=0) * n_pix).to(b_dtype)
        return dX, dC, db, None, None, None, None, None


def spectral_conv_fused(X: torch.Tensor, C: torch.Tensor,
                        b: torch.Tensor | None, nx: int, ny: int,
                        scale_by_dm: bool = True, compute_dtype=None, *,
                        m_global: int | None = None) -> torch.Tensor:
    """Batched pointwise complex conv through K1, differentiable — drop-in
    for :func:`spectralae_torch.ops.spectral.spectral_conv`:
    ``out[b,m,ω] = Σ_d (X[b,d,ω]/M)·C[m,d,ω]`` + ``b[m]·Nx·Ny`` on the DC
    bin (``conv_k``, source/fft_backproplib.cu:162-189).

    X: ``[B, D, Nx, Nyr]``, C: ``[M, D, Nx, Nyr]`` complex64, b: ``[M]``.
    ``compute_dtype=torch.bfloat16`` streams bf16 operands with float32
    sums and a complex64 result, forward and backward.  ``m_global`` (the
    whole stage's M, where C is a slice of its output channels) and
    ``b=None`` (no bias) are for a part of the conv
    (:class:`SpectralConvFused`).  Runs :class:`SpectralConvFused` on
    either device.
    """
    check_compute_dtype(compute_dtype)
    return SpectralConvFused.apply(X, C, b, nx, ny, scale_by_dm,
                                   compute_dtype, m_global)


def spectral_conv_pallas(X: torch.Tensor, C: torch.Tensor, b: torch.Tensor,
                         nx: int, ny: int, *,
                         scale_by_dm: bool = True) -> torch.Tensor:
    """Unbatched form kept under its JAX name: X ``[D, Nx, Nyr]`` →
    ``[M, Nx, Nyr]``.  The same kernel at batch 1, not a second kernel."""
    return spectral_conv_fused(X[None], C, b, nx, ny, scale_by_dm)[0]
