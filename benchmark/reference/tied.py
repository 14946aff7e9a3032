"""The plain reference of one train step of the tied, kernel-diverse net:
the source's 'p' and 'm' keys on the mirrored autoencoder.

Straight PyTorch, written from the source's description and not from the
code under test (it imports nothing of the program); the forwards, the
loss, autograd and the inertia update are :mod:`.autoencoder`'s, imported.
With ``cfg["sym"]`` and ``cfg["maxdiff"]`` (weights ``cfg["w0"]``,
``cfg["w1"]``), a step at weights ``w`` (``c``, ``b`` of each stage):

- the forward with each decoder stage's kernels set to its encoder's
  transposed, ``f[d][m] = c[m][d]`` with the taps not flipped
  (autoencoder.cpp:343-355);
- ½·mean((out − x)²) and its gradients by autograd, ``c`` and ``f`` as
  separate leaves; the fold ``g_c = ½(dc + dfᵀ)``, both biases' gradients
  halved, the decoder's kernels' gradient ``g_cᵀ`` (``backprop_gpu_cc``,
  backproplib.cu:521-644, its doubled ``Norm`` at 533);
- the combination ``g ← w0·g − w1·g_div`` on every stage
  (fft_backproplib.cu:1252): ``g_div`` of the kernels in the direct
  difference form of ``gradient_diff`` (fft_backproplib.cu:709-753),
  ``Σ_j (k_i − k_j) / ‖k_i − k_j‖²`` over the pairs whose two indices both
  differ (line 724), a zero distance counted as 1, taken from the stage's
  own kernels (a tied decoder's from its ``cᵀ``); of the biases
  ``Σ_{j≠i} 1/(b_i − b_j)``;
- the inertia update of the encoders' kernels and of every bias, then each
  decoder's kernels ``f ← cᵀ`` (backproplib.cu:622).

Departures from the source, which the port's step makes too:

- the tie in the fft domain: the source's FFT burst has no tied update
  (its 'p' key acts in the coordinate step, ``backprop_gpu_cc``); here it
  holds in either domain;
- the objective on every trained stage at once, where the source's burst
  applies it to the one stage pair it trains;
- the fold before the combination: the source's tied coordinate step has
  no diversity term and its diverse burst no fold; here the folded
  reconstruction gradient is combined.

:func:`follow` runs each step from the weights a program gave it,
:func:`train` its own steps from the seed's weights.
"""

from __future__ import annotations

import math

import torch

from . import autoencoder

#: elements of one block of pairwise differences
BLOCK = 1 << 25


def tie(leaves) -> list:
    """``leaves`` with each decoder stage's kernels replaced by its
    encoder's transposed."""
    out = list(leaves)
    n = len(leaves) // 2
    for p in range(n // 2):
        out[2 * (n - 1 - p)] = leaves[2 * p].transpose(0, 1).clone()
    return out


def kernel_repulsion(c: torch.Tensor) -> torch.Tensor:
    """``gradient_diff`` of ``[A,B,Nk,Nl]`` kernels: the differences of
    every pair, in blocks of rows of ``A``."""
    a, b = c.shape[:2]
    mm = ~torch.eye(a, dtype=torch.bool, device=c.device)
    bb = ~torch.eye(b, dtype=torch.bool, device=c.device)
    rows = max(1, BLOCK // (c.numel() * b))
    out = []
    for i in range(0, a, rows):
        diff = c[i:i + rows, :, None, None] - c[None, None]
        den = torch.sum(diff * diff, dim=(-2, -1))
        den = torch.where(den == 0, torch.ones_like(den), den)
        mask = mm[i:i + rows, None, :, None] & bb[None, :, None, :]
        out.append(torch.sum(diff / den[..., None, None]
                             * mask[..., None, None], dim=(2, 3)))
    return torch.cat(out)


def bias_repulsion(v: torch.Tensor) -> torch.Tensor:
    """``Σ_{j≠i} 1/(v_i − v_j)``, a zero difference counted as 1."""
    diff = v[:, None] - v[None, :]
    inv = 1.0 / torch.where(diff == 0, torch.ones_like(diff), diff)
    off = ~torch.eye(v.shape[0], dtype=torch.bool, device=v.device)
    return torch.sum(torch.where(off, inv, torch.zeros_like(inv)), dim=1)


def diversity(leaves, cfg: dict) -> list:
    """``w1·g_div`` of each leaf at ``leaves`` (a tied net's already
    tied)."""
    out = []
    for c, b in zip(leaves[0::2], leaves[1::2]):
        out += [cfg["w1"] * kernel_repulsion(c),
                cfg["w1"] * bias_repulsion(b)]
    return out


def step_grads(w, x: torch.Tensor, cfg: dict, domain: str, rows: int):
    """``(loss, grads, div)`` of one step at ``w``: the gradients as the
    update takes them (folded, combined) and the ``w1·g_div`` taken off
    them (None without ``maxdiff``)."""
    sym, n = cfg["sym"], len(w) // 2
    w = tie(w) if sym else list(w)
    loss, grads = autoencoder.loss_and_grads(w, x, cfg, domain, rows)
    grads = list(grads)
    if sym:
        for p in range(n // 2):
            e, d = 2 * p, 2 * (n - 1 - p)
            gc = 0.5 * (grads[e] + grads[d].transpose(0, 1))
            grads[e], grads[d] = gc, gc.transpose(0, 1)
            grads[e + 1], grads[d + 1] = 0.5 * grads[e + 1], \
                0.5 * grads[d + 1]
    div = None
    if cfg["maxdiff"]:
        div = diversity(w, cfg)
        grads = [cfg["w0"] * g - dv for g, dv in zip(grads, div)]
    return loss, grads, div


def update(w, grads, mom, cfg: dict):
    """The weights after the step and each leaf's change ``dw`` (``w −
    w'``); with ``sym`` the decoders' kernels are re-tied, and their
    change is what the re-tie made."""
    new = [autoencoder.update(wi, g, m, cfg["lr"], cfg["alpha"])
           for wi, g, m in zip(w, grads, mom)]
    out, dw = [t for t, _ in new], [d for _, d in new]
    if cfg["sym"]:
        n = len(w) // 2
        for p in range(n // 2):
            d = 2 * (n - 1 - p)
            out[d] = out[2 * p].transpose(0, 1).clone()
            dw[d] = w[d] - out[d]
    return out, dw


def follow(states, batches, cfg: dict, domain: str, *,
           dtype=torch.float64, rows: int = 4) -> dict:
    """Each step of the reference from the weights a program gave that
    step: step ``k`` starts from ``states[k]`` with the inertia
    ``states[k-1] - states[k]`` (none at the first step) and runs on
    ``batches[k]``.  Returns each step's loss, gradient, update ``dw``
    and ``div`` (each leaf's ``w1·g_div``, or None)."""
    out = {"losses": [], "grads": [], "updates": [], "div": []}
    prev = None
    for w, x in zip(states, batches):
        w = [t.detach().to(dtype) for t in w]
        mom = ([a - b for a, b in zip(prev, w)] if prev is not None
               else [torch.zeros_like(t) for t in w])
        loss, grads, div = step_grads(w, x.to(dtype), cfg, domain, rows)
        if not math.isfinite(float(loss)):
            raise FloatingPointError(f"reference loss not finite: {loss}")
        out["losses"].append(float(loss))
        out["grads"].append([g.detach() for g in grads])
        out["updates"].append(update(w, grads, mom, cfg)[1])
        out["div"].append(div)
        prev = w
    return out


def train(leaves, batches, cfg: dict, domain: str, *,
          dtype=torch.float64, tf32: bool = False, rows: int = 4) -> dict:
    """Run the reference over ``batches`` (one step each) from ``leaves``
    with zero inertia, in ``dtype``, as a program the check judges.
    Returns each step's loss, the first step's gradient, ``params`` (the
    weights each step receives, and those after the last) and ``div``
    (each step's ``w1·g_div``, or None)."""
    w = [t.detach().to(dtype) for t in leaves]
    states = [w]
    mom = [torch.zeros_like(t) for t in w]
    losses, grad1, divs = [], None, []
    with autoencoder.precision(tf32):
        for x in batches:
            loss, grads, div = step_grads(w, x.to(dtype), cfg, domain, rows)
            losses.append(float(loss))
            divs.append(div)
            if grad1 is None:
                grad1 = [g.detach() for g in grads]
            w, mom = update(w, grads, mom, cfg)
            states.append(w)
    if not all(math.isfinite(v) for v in losses):
        raise FloatingPointError(f"reference loss not finite: {losses}")
    return {"losses": losses, "grad1": grad1, "params": states,
            "div": divs}
