"""Iteration-grid omega-space burst: the whole burst in one kernel launch.

Port of :mod:`spectralae.train.fft_iter`.  The two-kernel engines
(:mod:`spectralae_torch.train.fft_pallas`) pay, per inner iteration, one or
two launches plus the inertia update as tensor code on the host.  Here the
reference's 100-iteration loop (source/fft_backproplib.cu:1446-1464) runs
inside one cooperative launch of K8
(:func:`spectralae_torch.ops.burst_kernels.itergrid`): every block stays
resident and sweeps its 64-bin tiles with the tensor-core sweep of K5 and
K7 (the spectra rebuild and the projection on ``wgmma``); the per-tile
gradient partials are summed in a fixed order (groups of 16 tiles in tile
order, then the groups) between grid barriers, and every block applies
the inertia to its own copy of the weights.

Iteration 0 is the gradient pass on the caller's O₀ (which also gives
``mses[0]``).  The Hermitian weights are folded into E = O − Y once, as the
JAX kernel does; ``diff·w = E·(E·w)`` gives the weighted MSE.  Semantics
equal ``fft_burst`` (no ``maxdiff``, one device — ``auto_burst`` never
picks this engine).
"""

from __future__ import annotations

import torch

from ..ops import burst_kernels as bk
from ..ops import dft
from .fft import FFTBurstResult, zero_moms
from .fft_pallas import _mse_of, _prepare, _stack


@dft.ieee_f32()
def burst_itergrid(x, expout, out0, c, f, b, p, mom=None, *, lr=0.2,
                   alpha=0.9, iters=100, scale_by_dm=True,
                   mxu_dtype=torch.float32) -> FFTBurstResult:
    """One-launch burst; ``x/expout/out0``: ``[D, h, w]`` (the reference
    burst) or ``[B, D, h, w]`` (batch-averaged gradients, ``fft_burst_dp``
    semantics)."""
    s = _prepare(x, expout, out0, c, scale_by_dm, mxu_dtype)
    P = c.shape[-2] * c.shape[-1]
    mom = mom if mom is not None else zero_moms(c, f, b, p)
    cf, bn, pn, mcf, mb, mp, mse_raw = bk.itergrid(
        s.planes, s.basis, s.wv, _stack(c, f, s.md, P), b, p,
        _stack(mom[0], mom[1], s.md, P), mom[2], mom[3], iters=iters,
        lr_eff=0.1 * lr, alpha=alpha, mxu_bf16=s.bf16, **s.consts)
    md = s.md
    return FFTBurstResult(
        c=cf[:md].reshape(c.shape), f=cf[md:].reshape(f.shape), b=bn, p=pn,
        mom=(mcf[:md].reshape(c.shape), mcf[md:].reshape(f.shape), mb, mp),
        mses=_mse_of(mse_raw, c, s.nx, s.ny).to(x.dtype))


fft_burst_itergrid = burst_itergrid
