"""Coordinate-space training step (reference-semantics gradients, vectorized).

Port of :mod:`spectralae.train.coord`.  The reference launches one CUDA
grid + two device→host Thrust reductions *per weight element* — M·D·Nk·Nl
sequential launches per step (``backprop_gpu``,
source/backproplib.cu:363-417).  The gradients themselves are linear
functionals of the activations, so here the full gradient set is three
transposed reference-semantics convolutions (``torch.autograd.grad`` of the
linear :func:`spectralae_torch.ops.coord.conv2d`, the JAX package's
``jax.linear_transpose``); a patch-matmul formulation is available via
``impl='patches'``.

Identity derivation: with E = out−in and the reference conv ``∗`` (tap-window
semantics of :mod:`spectralae_torch.ops.coord`, no /dM, no bias, identity
act),

  dDdC = ∂/∂c ⟨E, f ∗ (c ∗ in)⟩ / Norm       (gradient_CF/CFBP, 186-288)
  dDdF = ∂/∂f ⟨E, f ∗ hin⟩ / Norm
  dDdB = Σ_pix ∂/∂h ⟨E, f ∗ h⟩|_{h=hin} / Norm
  dDdP = Σ_pix E / Norm

with Norm = D·M·Nk·Nl·Nx·Ny (backproplib.cu:303).

Deliberate bug-fixes vs the reference (documented per SURVEY.md §7):
- ``dDdB`` accumulates over all input channels (the reference's ``dDdB2=``
  assignment at backproplib.cu:220 drops all but the last — the symmetric
  variant at line 457 uses ``+=``, showing the intent);
- the ``(i-ik)*Nx``/``j-ik`` indexing bugs (lines 226, 283) are not copied.

:func:`distributed_coord_step` is the data-parallel step over a mesh
(:mod:`spectralae_torch.dist.mesh`): each rank's batch-averaged gradients
pmean-ed over the data axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.config import TapMode, tap_anchor
from ..dist import collectives
from ..losses.losses import mse_coord
from ..ops import coord
from ..ops.dft import ieee_f32
from ..optim.update import normalized_momentum_update
from .fft import zero_moms


class CoordGrads(NamedTuple):
    dc: torch.Tensor   # [M, D, Nk, Nl]
    df: torch.Tensor   # [D, M, Nk, Nl]
    db: torch.Tensor   # [M]
    dp: torch.Tensor   # [D]


def _transpose_patches(E: torch.Tensor, nk: int, nl: int,
                       tap_mode: TapMode) -> torch.Tensor:
    """Patches ``P[..., c, (k,l), a, b] = E_padded[..., c, a+ik0+k, b+il0+l]``
    of ``E`` ``[..., C, H, W]``.

    The transpose of the reference tap window ``out[i] = Σ c[k]·in[i−ik0−k]``
    — its padding is the forward padding reversed.  A positive anchor makes
    a pad negative, which ``F.pad`` takes as a crop.
    """
    ik0, il0 = tap_anchor(nk, tap_mode), tap_anchor(nl, tap_mode)
    *lead, h, w = E.shape
    ep = F.pad(E.reshape(-1, 1, h, w),
               (-il0, nl - 1 + il0, -ik0, nk - 1 + ik0))
    return F.unfold(ep, (nk, nl)).reshape(*lead, nk * nl, h, w)


def _ref_cpu_mask(t: torch.Tensor) -> torch.Tensor:
    """Row and column 0 zeroed: the strict ``i-ik > 0`` bound of the CPU
    reference (netlib.cpp:344), which :func:`coord.conv2d` applies to its
    input."""
    t = t.clone()
    t[..., 0, :] = 0.0
    t[..., :, 0] = 0.0
    return t


@ieee_f32()
def _batch_gradients(in_b: torch.Tensor, out_b: torch.Tensor,
                     hin_b: torch.Tensor, f: torch.Tensor, nk: int, nl: int,
                     tap_mode: TapMode, impl: str) -> CoordGrads:
    """The per-frame gradients of ``[B, D, h, w]`` / ``[B, M, h, w]``
    frames, averaged over the batch, in IEEE float32 (the transposes'
    cuDNN convs and the patch products with TF32 off)."""
    nb, D, Nx, Ny = in_b.shape
    M = hin_b.shape[1]
    Norm = float(D * M * nk * nl * Nx * Ny) * nb
    in_b, out_b, hin_b, f = (t.detach() for t in (in_b, out_b, hin_b, f))
    E = out_b - in_b
    if impl == "patches":
        # δh[b,m] = Σ_{d',k,l} f[d',m,k,l]·E[b,d', ·+ik0+k, ·+il0+l]
        # df[d',m,k,l] = Σ_bab hin[b,m,ab]·E[b,d', a+ik0+k, b+il0+l]
        # dc[m,d,k,l]  = Σ_bab in[b,d,ab]·δh[b,m, a+ik0+k, b+il0+l]
        if tap_mode == "ref_cpu":
            # the strict bound masks the conv *inputs*' row/col 0; the
            # transposes inherit the diagonal mask
            in_b, hin_b = _ref_cpu_mask(in_b), _ref_cpu_mask(hin_b)
        PE = _transpose_patches(E, nk, nl, tap_mode)         # [B,D,P,h,w]
        delta_h = torch.einsum("dmp,ndpab->nmab",
                               f.reshape(D, M, nk * nl), PE)
        if tap_mode == "ref_cpu":
            delta_h = _ref_cpu_mask(delta_h)
        Pd = _transpose_patches(delta_h, nk, nl, tap_mode)   # [B,M,P,h,w]
        dc = torch.einsum("ndab,nmpab->mdp", in_b, Pd).reshape(M, D, nk, nl)
        df = torch.einsum("nmab,ndpab->dmp", hin_b, PE).reshape(D, M, nk, nl)
    elif impl == "transpose":
        # three transposed convs as gradients of ⟨conv(·), cotangent⟩ (the
        # maps are linear, so no primal value matters).  pallas=False
        # keeps them on F.conv2d, as the JAX package keeps its transposes
        # off its Pallas conv; autograd is switched on here, so an engine
        # loop under no_grad or inference_mode cannot turn it off
        conv = dict(tap_mode=tap_mode, scale_by_dm=False, pallas=False)
        with torch.inference_mode(False), torch.enable_grad():
            h = hin_b.clone().requires_grad_()
            fw = f.clone().requires_grad_()
            delta_h, df = torch.autograd.grad(
                coord.conv2d(h, fw, None, **conv), (h, fw), E.clone())
            cw = torch.zeros((M, D, nk, nl), dtype=in_b.dtype,
                             device=in_b.device, requires_grad=True)
            (dc,) = torch.autograd.grad(
                coord.conv2d(in_b.clone(), cw, None, **conv), cw, delta_h)
    else:
        raise ValueError(f"impl must be 'transpose' or 'patches', "
                         f"got {impl!r}")
    return CoordGrads(dc=dc / Norm, df=df / Norm,
                      db=delta_h.sum(dim=(0, 2, 3)) / Norm,
                      dp=E.sum(dim=(0, 2, 3)) / Norm)


def coord_ref_gradients(in_s: torch.Tensor, out_s: torch.Tensor,
                        hin_s: torch.Tensor, f: torch.Tensor, nk: int,
                        nl: int, *, tap_mode: TapMode = "ref_gpu",
                        impl: str = "transpose") -> CoordGrads:
    """Reference-exact coordinate gradients for one stage pair.

    Args:
      in_s/out_s: ``[D, h, w]`` cropped input / reconstruction
        (``Portion`` of the *full-frame* forward — the reference trains on
        mismatched crop boundaries by design, autoencoder.cpp:169).
      hin_s: ``[M, h, w]`` cropped hidden feature maps.
      f: ``[D, M, Nk, Nl]`` decoder kernels.
      impl: 'transpose' (default) — three transposed convs through
        autograd of the linear conv; 'patches' materializes tap-window
        patches (``F.unfold``) and forms the gradients as long-contraction
        einsums — the JAX package's tested alternative formulation.
    """
    return _batch_gradients(in_s[None], out_s[None], hin_s[None], f, nk, nl,
                            tap_mode, impl)


class CoordStepResult(NamedTuple):
    c: torch.Tensor
    f: torch.Tensor
    b: torch.Tensor
    p: torch.Tensor
    mom: tuple          # (Dc, Df, Db, Dp)
    prev_grad: tuple    # (ddc, ddf, ddb, ddp) for the adaptive-lr rule
    mse: torch.Tensor   # the printed coord mse (backproplib.cu:356)


def coord_step(in_s: torch.Tensor, out_s: torch.Tensor, hin_s: torch.Tensor,
               c: torch.Tensor, f: torch.Tensor, b: torch.Tensor,
               p: torch.Tensor, mom: tuple, prev_grad: tuple, *,
               lr: float = 0.2, alpha: float = 0.9,
               tap_mode: TapMode = "ref_gpu", sym: bool = False,
               active: bool = False) -> CoordStepResult:
    """One coordinate-space train step on the selected stage pair.

    ``sym=False``: ``backprop_gpu`` (backproplib.cu:291-418) — untied c and f.
    ``sym=True``: ``backprop_gpu_cc`` (521-644) — the c and f gradients are
    folded (Norm doubled, line 533), only c is updated, and f is re-tied to
    ``cᵀ`` (line 622).  Biases remain independently trained.
    """
    dM, dD, nk, nl = c.shape
    g = coord_ref_gradients(in_s, out_s, hin_s, f, nk, nl, tap_mode=tap_mode)
    mse = mse_coord(in_s.detach(), out_s.detach(), dM, nk, nl)
    return _apply_update(g, mse, c, f, b, p, mom, prev_grad,
                         lr=lr, alpha=alpha, sym=sym, active=active)


def _apply_update(g: CoordGrads, mse, c, f, b, p, mom, prev_grad, *,
                  lr, alpha, sym, active) -> CoordStepResult:
    Dc, Df, Db, Dp = mom
    ddc, ddf, ddb, ddp = prev_grad
    if sym:
        gc = 0.5 * (g.dc + g.df.transpose(0, 1))
        gb, gp = 0.5 * g.db, 0.5 * g.dp
        c, Dc, ddc = normalized_momentum_update(c, gc, Dc, ddc, lr, alpha,
                                                active=active)
        b, Db, ddb = normalized_momentum_update(b, gb, Db, ddb, lr, alpha,
                                                active=active)
        p, Dp, ddp = normalized_momentum_update(p, gp, Dp, ddp, lr, alpha,
                                                active=active)
        f = c.transpose(0, 1)
        mse = mse / 2.0  # Norm doubled in the cc variant (line 533)
    else:
        c, Dc, ddc = normalized_momentum_update(c, g.dc, Dc, ddc, lr, alpha,
                                                active=active)
        f, Df, ddf = normalized_momentum_update(f, g.df, Df, ddf, lr, alpha,
                                                active=active)
        b, Db, ddb = normalized_momentum_update(b, g.db, Db, ddb, lr, alpha,
                                                active=active)
        p, Dp, ddp = normalized_momentum_update(p, g.dp, Dp, ddp, lr, alpha,
                                                active=active)
    return CoordStepResult(c=c, f=f, b=b, p=p,
                           mom=(Dc, Df, Db, Dp),
                           prev_grad=(ddc, ddf, ddb, ddp), mse=mse)


def coord_step_dp(in_b: torch.Tensor, out_b: torch.Tensor,
                  hin_b: torch.Tensor, c: torch.Tensor, f: torch.Tensor,
                  b: torch.Tensor, p: torch.Tensor, mom: tuple,
                  prev_grad: tuple, *, lr: float = 0.2, alpha: float = 0.9,
                  tap_mode: TapMode = "ref_gpu", sym: bool = False,
                  active: bool = False, axis_name=None) -> CoordStepResult:
    """Batched coordinate-space step: reference-exact gradients averaged
    over a batch of ``[B, ·, h, w]`` frames (the coord analog of
    ``fft_burst_dp``).  Each frame's ``Norm`` counts one frame, so the
    batched transposes sum over B and divide by B.  At B=1 it equals
    :func:`coord_step`.

    ``axis_name`` (the data axis's process group): the frames are this
    rank's batch shard, and the (tiny) averaged gradients and the mse are
    pmean-ed over the axis in one all_reduce before the update — the same
    collective pattern as the distributed burst.  The gradients stay the
    transposed convolutions: the JAX package takes its ``"patches"`` form
    under an axis only because ``jax.linear_transpose`` with respect to a
    replicated argument inserts a hidden psum there (coord.py:219-224);
    ``torch.autograd.grad`` of the rank's own tensors has none.
    """
    dM, dD, nk, nl = c.shape
    g = _batch_gradients(in_b, out_b, hin_b, f, nk, nl, tap_mode,
                         "transpose")
    diff = (in_b - out_b).detach()
    mse = torch.mean(torch.sum(diff * diff, dim=(-3, -2, -1))) / (
        dD * dM * nk * nl * in_b.shape[-2] * in_b.shape[-1])
    if axis_name is not None:
        *parts, mse = collectives.pmean([*g, mse], axis_name)
        g = CoordGrads(*parts)
    return _apply_update(g, mse, c, f, b, p, mom, prev_grad,
                         lr=lr, alpha=alpha, sym=sym, active=active)


def distributed_coord_step(mesh, *, lr: float = 0.2, alpha: float = 0.9,
                           tap_mode: TapMode = "ref_gpu", sym: bool = False,
                           active: bool = False):
    """A multi-rank coord step over ``mesh``: the frame batch sharded over
    ``data``, the weights replicated, the gradients pmean-ed — the coord
    analog of :func:`spectralae_torch.train.fft_dp.distributed_burst`.  The
    returned ``run(in_b, out_b, hin_b, c, f, b, p, mom=None,
    prev_grad=None)`` takes this rank's shard of the batch; each step's
    collective moves ``M·D·Nk·Nl·2 + M + D + 1`` floats (the averaged
    gradients and the mse), nothing resolution-sized."""
    data = mesh.axis("data")

    def run(in_b, out_b, hin_b, c, f, b, p, mom=None, prev_grad=None):
        collectives.check_shards(in_b.shape[0], data)
        return coord_step_dp(
            in_b, out_b, hin_b, c, f, b, p,
            mom if mom is not None else zero_moms(c, f, b, p),
            prev_grad if prev_grad is not None else zero_moms(c, f, b, p),
            lr=lr, alpha=alpha, tap_mode=tap_mode, sym=sym, active=active,
            axis_name=data)

    return run
