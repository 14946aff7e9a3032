"""The comparison that decides ``correct`` for a training cell.

The program's first steps, taken at set-up through the window's own call
and feed, are held step by step against the plain reference
(:mod:`benchmark.reference.autoencoder` ``follow``): the first step from
the seed's weights, and each later one from the weights the program gave
it, with the inertia those weights imply.  The numbers:

- ``loss_gap``: the largest gap of a step's loss, over the reference's;
- ``grad_gap``: the first gradient as the optimizer got it (its state
  after one step), by the worst leaf: the gap between the program's norm
  and the reference's, over the larger of that leaf's reference norm and
  the median leaf's;
- ``update_gap``: the same for each step's update, the change of the
  weights as the next step receives them, by the worst leaf and step.

Two rules leave out what rounding alone decides.  A leaf whose first
reference gradient is under a thousandth of the median leaf's moves by
round-off, and its updates are not compared.  Within a leaf, an element
whose reference gradient at that step is under ``ROUNDED`` of the leaf's
largest is left out of that step's update: the update is
``lr·(1−α)·g / max(|g|, 10)``, in effect the sign of ``g`` where the
gradients run to millions, and float32 sums over a batch of frames leave
such an element's sign to rounding (PERF.md gives the readings).

Why step by step: a sign so decided moves its weight by 0.02 to 0.04 on
one side and not the other, and the next steps start from weights that
differ by that much, so a chain run apart from the program departs from it
on some seeds as far as a lower precision does, in float32 as in the
program.  Each step followed from the program's own weights keeps the
comparison to what that step did.

A run is correct when every number its cell's limits name is finite and
within its limit.
"""

from __future__ import annotations

import math
import statistics

import torch

#: a leaf's first reference gradient under this share of the median leaf's
#: is round-off, and its updates are not compared
DEAD_LEAF = 1e-3
#: an element's reference gradient under this share of its leaf's largest
#: at a step leaves the sign of that step's update to rounding
ROUNDED = 1e-5


def _norms(leaves) -> list[float]:
    return [float(torch.linalg.vector_norm(t.detach().double()))
            for t in leaves]


def leaf_gaps(got, want, counted=None) -> list[float]:
    """Each leaf's gap of norms, over the larger of its reference norm and
    the median leaf's."""
    gn, wn = _norms(got), _norms(want)
    if len(gn) != len(wn):
        return [math.inf]
    med = statistics.median(wn)
    idx = range(len(wn)) if counted is None else counted
    return [abs(gn[i] - wn[i]) / max(wn[i], med) for i in idx]


def _worst(gaps) -> float:
    """The largest gap; inf for none, or where one is not a number."""
    if not gaps or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def kept(grads) -> list[torch.Tensor]:
    """Each leaf's mask of the elements whose update rounding does not
    decide: reference gradient at least ``ROUNDED`` of the leaf's
    largest."""
    out = []
    for g in grads:
        a = g.detach().abs()
        out.append(a >= ROUNDED * a.max())
    return out


def update_gaps(prog_params, ref: dict, live) -> list[float]:
    """Every live leaf's gap of update norms at every step, over the
    elements :func:`kept` keeps."""
    gaps = []
    if len(prog_params) != len(ref["updates"]) + 1:
        return [math.inf]
    for k, (dw, grads) in enumerate(zip(ref["updates"], ref["grads"])):
        got = [(a.double() - b.double())
               for a, b in zip(prog_params[k], prog_params[k + 1])]
        if len(got) != len(dw):
            return [math.inf]
        masks = kept(grads)
        gaps += leaf_gaps([t[m] for t, m in zip(got, masks)],
                          [t[m] for t, m in zip(dw, masks)], live)
    return gaps


def readings(prog: dict, ref: dict) -> dict:
    """The numbers compared.  ``prog`` holds a program's ``losses``, its
    first gradient ``grad1`` and ``params``, the weights each step
    received and those after the last; ``ref`` is
    :func:`benchmark.reference.autoencoder.follow` over those weights."""
    if len(prog["losses"]) != len(ref["losses"]):
        losses = [math.inf]
    else:
        losses = [abs(p - r) / abs(r)
                  for p, r in zip(prog["losses"], ref["losses"])]
    gref = _norms(ref["grads"][0])
    med = statistics.median(gref)
    live = [i for i, g in enumerate(gref) if g >= DEAD_LEAF * med]
    return {"loss_gap": _worst(losses),
            "grad_gap": _worst(leaf_gaps(prog["grad1"], ref["grads"][0])),
            "update_gap": _worst(update_gaps(prog["params"], ref, live))}
