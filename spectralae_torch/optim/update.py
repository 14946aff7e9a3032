"""The reference's optimizer as functional tensor updates.

Port of :mod:`spectralae.optim.update`.  Update rule (used identically in
every training path of the reference — backproplib.cu:392-396, 620-621;
fft_backproplib.cu:616-617):

    dw ← (1−α)·lr·g / max(|g|, 10) + α·dw_prev
    w  ← w − dw

i.e. momentum ("inertia") over a normalized/clipped gradient.  The adaptive
learning rate ``lr = |Δw_prev / Δg|`` exists in the reference but is dead code
(``del=delmax`` unconditionally re-applied, backproplib.cu:34; device variants
commented out at fft_backproplib.cu:615-623).  Here the *intended* rule is
implemented behind ``active=True`` and the reference behavior is
``active=False`` (the default), per SURVEY.md §7 "reference quirks".

Every function returns new tensors and updates none it was given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.types import AEParams

GRAD_CLIP = 10.0  # the max(|g|, 10) normalization floor


class UpdateResult(NamedTuple):
    w: torch.Tensor
    mom: torch.Tensor
    prev_grad: torch.Tensor


def normalized_momentum_update(w: torch.Tensor, g: torch.Tensor,
                               mom: torch.Tensor, prev_grad: torch.Tensor,
                               lr: float, alpha: float, *,
                               active: bool = False) -> UpdateResult:
    """One inertia step on a single tensor; returns (w', mom', prev_grad')."""
    if active:
        # Intended adaptive rule: per-weight secant step |Δw / Δg|, capped at
        # the keyboard-set lr (cf. adapt_rate, backproplib.cu:28-35).
        # Bootstrap: with zero momentum (fresh start / after a layer-focus
        # reset) the secant numerator is 0 and would freeze training
        # forever — fall back to the plain lr until momentum exists.
        dg = g - prev_grad
        secant = torch.abs(mom / torch.where(dg == 0, torch.ones_like(dg),
                                             dg))
        lr_eff = torch.where((dg != 0) & (mom != 0), secant,
                             torch.full_like(g, lr))
        lr_eff = torch.clamp(lr_eff, max=lr)
    else:
        lr_eff = lr
    dw = (1.0 - alpha) * lr_eff * g / torch.clamp(torch.abs(g),
                                                  min=GRAD_CLIP) \
        + alpha * mom
    return UpdateResult(w - dw, dw, g)


def tree_update(params: AEParams, grads: AEParams, moms: AEParams,
                prev_grads: AEParams, lr: float, alpha: float, *,
                active: bool = False):
    """Apply the update to every tensor of the parameter tape; returns
    ``(params', moms', prev_grads')``.

    The fixed-rate update runs each of its elementwise operations on every
    leaf at once (``torch._foreach_*``: one launch an operation on the
    card, not one a leaf), in :func:`normalized_momentum_update`'s order,
    so each value is the same bit for bit."""
    if active:
        out = [normalized_momentum_update(w, g, m, pg, lr, alpha,
                                          active=True)
               for w, g, m, pg in zip(params.leaves(), grads.leaves(),
                                      moms.leaves(), prev_grads.leaves())]
        return (AEParams.from_leaves([o.w for o in out]),
                AEParams.from_leaves([o.mom for o in out]),
                AEParams.from_leaves([o.prev_grad for o in out]))
    gs = grads.leaves()
    dw = torch._foreach_mul(gs, (1.0 - alpha) * lr)
    torch._foreach_div_(dw, torch._foreach_clamp_min(torch._foreach_abs(gs),
                                                     GRAD_CLIP))
    torch._foreach_add_(dw, torch._foreach_mul(moms.leaves(), alpha))
    return (AEParams.from_leaves(torch._foreach_sub(params.leaves(), dw)),
            AEParams.from_leaves(dw), grads)


def burst_inertia(w: torch.Tensor, g: torch.Tensor, mom: torch.Tensor,
                  lr_eff: float, alpha: float, scale=None):
    """The burst weight update (``backprop_d``, fft_backproplib.cu:605-652):
    normalized/clipped gradient with inertia, effective lr already scaled
    (the reference burst uses ``0.1·del``).

    ``scale``: optional per-entry rescale of the clipped step (not the
    momentum).

    Returns ``(new_w, new_mom)``.
    """
    step = (1.0 - alpha) * lr_eff * g / torch.clamp(torch.abs(g),
                                                    min=GRAD_CLIP)
    if scale is not None:
        step = scale * step
    dw = step + alpha * mom
    return w - dw, dw
