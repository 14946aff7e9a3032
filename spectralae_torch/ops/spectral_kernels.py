"""Hand-written CUDA kernel for the momentum-space conv (K1).

Counterpart of :mod:`spectralae.ops.pallas_kernels`.  The reference's hot
device kernel is the pointwise complex-multiply convolution ``conv_k``
(source/fft_backproplib.cu:162-189); here it is ``csrc/cmul_contract.cu``,
a per-bin complex contraction that reads complex64 as interleaved
``float2`` and fuses the ``1/M`` input scale and the DC-bin bias into its
one pass.  The file's header note says what bounds it and why it is shaped
as it is.

Every wrapper runs the kernel's plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors — never the plain version, and never a
library kernel in its place.  :data:`LAUNCHES` counts kernel launches.

Forward only: the backward (the JAX package's custom VJP, two more
contractions) and bf16 operands are ROADMAP queue B work ("B1 VJP",
"B1 bf16 operands"); asking for either raises.
"""

from __future__ import annotations

import torch

from .. import _kernels

#: kernel launches of :func:`cmul_contract` since import (or the last reset)
LAUNCHES = 0


def cmul_contract_plain(p: torch.Tensor, q: torch.Tensor, *,
                        p_scale: float = 1.0,
                        bias: torch.Tensor | None = None,
                        bias_scale: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`cmul_contract`: the same math as einsum.

    ``out[a,b,w] = Σ_k (p_scale·p[a,k,w])·q[k,b,w]``, plus
    ``bias[b]·bias_scale`` on bin ``w = 0`` when ``bias`` is given.
    """
    out = torch.einsum("akw,kbw->abw", p * p_scale, q)
    if bias is not None:
        # the einsum result is fresh, so the DC add may update it in place
        out[:, :, 0] += (bias * bias_scale).to(out.dtype)
    return out


def _check_contract(p, q, bias) -> None:
    if p.dtype != torch.complex64 or q.dtype != torch.complex64:
        raise TypeError(f"cmul_contract takes complex64, got {p.dtype} and "
                        f"{q.dtype} (bf16 operands: ROADMAP 'B1 bf16 "
                        "operands')")
    if p.dim() != 3 or q.dim() != 3:
        raise ValueError(f"p must be [A,K,W] and q [K,B,W], got "
                         f"{tuple(p.shape)} and {tuple(q.shape)}")
    if p.shape[1] != q.shape[0] or p.shape[2] != q.shape[2]:
        raise ValueError(f"shape mismatch: p {tuple(p.shape)}, "
                         f"q {tuple(q.shape)}")
    if min(p.shape) == 0 or q.shape[1] == 0:
        raise ValueError("cmul_contract needs non-empty operands")
    if p.device != q.device:
        raise ValueError(f"p on {p.device}, q on {q.device}")
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.shape != (q.shape[1],)
                or bias.device != p.device):
            raise ValueError(f"bias must be float32 [{q.shape[1]}] on "
                             f"{p.device}, got {bias.dtype} "
                             f"{tuple(bias.shape)} on {bias.device}")


def _check_no_grad(name: str, *ts) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward-only; its backward is "
            "ROADMAP queue B work")


def cmul_contract(p: torch.Tensor, q: torch.Tensor, *,
                  p_scale: float = 1.0,
                  bias: torch.Tensor | None = None,
                  bias_scale: float = 0.0) -> torch.Tensor:
    """Per-bin complex contraction ``[A,K,W] × [K,B,W] → [A,B,W]`` (K1).

    ``p`` must be contiguous; ``q`` may be any view whose last axis is
    contiguous (the spectral conv passes its ``[M, D, W]`` kernel spectra
    transposed, with no copy).  CPU tensors take
    :func:`cmul_contract_plain`; CUDA tensors launch the kernel.
    """
    global LAUNCHES
    _check_contract(p, q, bias)
    if p.device.type == "cpu":
        return cmul_contract_plain(p, q, p_scale=p_scale, bias=bias,
                                   bias_scale=bias_scale)
    if p.device.type != "cuda":
        raise ValueError(f"cmul_contract runs on cpu or cuda, not {p.device}")
    _check_no_grad("cmul_contract", p, q, bias)
    if not p.is_contiguous() or q.stride(2) != 1:
        raise ValueError("cmul_contract needs a contiguous p and a q whose "
                         "last axis is contiguous")
    if bias is not None and not bias.is_contiguous():
        raise ValueError("bias must be contiguous")
    a, k, w = p.shape
    b = q.shape[1]
    if a > 65535:
        raise ValueError(f"cmul_contract: A={a} exceeds the grid's y limit "
                         "of 65535")
    out = torch.empty((a, b, w), dtype=torch.complex64, device=p.device)
    with torch.cuda.device(p.device):
        err = _kernels.lib().cmul_contract_launch(
            p.data_ptr(), q.data_ptr(), out.data_ptr(), a, k, b, w,
            q.stride(0), q.stride(1), float(p_scale),
            None if bias is None else bias.data_ptr(), float(bias_scale),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(err, "cmul_contract")
    LAUNCHES += 1
    return out


def spectral_conv_fused(X: torch.Tensor, C: torch.Tensor, b: torch.Tensor,
                        nx: int, ny: int, scale_by_dm: bool = True,
                        compute_dtype=None) -> torch.Tensor:
    """Batched pointwise complex conv through K1 — drop-in for
    :func:`spectralae_torch.ops.spectral.spectral_conv`:
    ``out[b,m,ω] = Σ_d (X[b,d,ω]/M)·C[m,d,ω]`` + ``b[m]·Nx·Ny`` on the DC
    bin (``conv_k``, source/fft_backproplib.cu:162-189).

    X: ``[B, D, Nx, Nyr]``, C: ``[M, D, Nx, Nyr]`` complex64, b: ``[M]``.
    """
    if compute_dtype is not None:
        raise NotImplementedError("compute_dtype: bf16 operands for K1 are "
                                  "ROADMAP queue B 'B1 bf16 operands'")
    nb, d = X.shape[0], X.shape[1]
    m = C.shape[0]
    nyr = ny // 2 + 1
    w = nx * nyr
    scale = (1.0 / m) if scale_by_dm else 1.0
    p = X.reshape(nb, d, w).contiguous()
    q = C.reshape(m, d, w).transpose(0, 1)      # [D, M, W] view, no copy
    out = cmul_contract(p, q, p_scale=scale,
                        bias=b.to(torch.float32).contiguous(),
                        bias_scale=float(nx * ny))
    return out.reshape(nb, m, nx, nyr)


def spectral_conv_pallas(X: torch.Tensor, C: torch.Tensor, b: torch.Tensor,
                         nx: int, ny: int, *,
                         scale_by_dm: bool = True) -> torch.Tensor:
    """Unbatched form kept under its JAX name: X ``[D, Nx, Nyr]`` →
    ``[M, Nx, Nyr]``.  The same kernel at batch 1, not a second kernel."""
    return spectral_conv_fused(X[None], C, b, nx, ny, scale_by_dm)[0]
