"""Batched momentum-space bursts: one kernel pair, many frames.

Port of :mod:`spectralae.train.fft_dp`.  A capability beyond the
reference (whose burst trains on a single frozen frame): the analytic
frequency-domain gradients are averaged over a batch of frozen patches
each inner iteration.  Semantics reduce exactly to the reference burst at
B=1.

:func:`distributed_burst` shards the batch over the mesh's ``data`` axis
(every rank runs the body on its shard, :mod:`spectralae_torch.dist.mesh`)
and, with a ``model`` axis, the correlation-space precompute over it.
"""

from __future__ import annotations

import torch

from ..dist import collectives
from ..ops import dft, spectral
from ..optim.update import burst_inertia
from .fft import FFTBurstResult, zero_moms


def _gradient_k_io_batch(X, Y, O, Cf, Ff, b, nx, ny, axis_name=None):
    """Batch-averaged analytic gradients (see train.fft.gradient_k_io);
    ``axis_name`` (the data axis's process group) pmeans them over the
    batch shards, in one all_reduce."""
    dM, dD = Cf.shape[0], Cf.shape[1]
    norm = nx * ny
    Norm = norm * 2.0 * dM * dD * nx * ny
    E = O - Y                                               # [B, D, x, y]
    S = torch.einsum("bdxy,dmxy->bmxy", E, Ff.conj())
    H = torch.einsum("mdxy,bdxy->bmxy", Cf, X)
    H[:, :, 0, 0] += b.to(H.dtype) * norm
    nb = X.shape[0]
    dc = torch.einsum("bmxy,bdxy->mdxy", S, X.conj()) / (Norm * nb)
    df = torch.einsum("bdxy,bmxy->dmxy", E, H.conj()) / (Norm * nb)
    db = torch.mean(S[:, :, 0, 0].real, dim=0) * norm / Norm
    dp = torch.mean(E[:, :, 0, 0].real, dim=0) * norm / Norm
    if axis_name is not None:
        dc, df, db, dp = collectives.pmean([dc, df, db, dp], axis_name)
    return dc, df, db, dp


def _burst_dp_body(x, expout, out0, c, f, b, p, mom, *, lr, alpha, iters,
                   scale_by_dm, axis_name, maxdiff=False, w0=1.0, w1=10.0):
    nx, ny = x.shape[-2], x.shape[-1]
    dM, dD, nk, nl = c.shape
    del_eff = 0.1 * lr
    X = spectral.rfft2(x)
    Y = spectral.rfft2(expout)
    O = spectral.rfft2(out0)

    def batch_mse(Yb, Ob):
        return torch.mean(torch.stack([
            spectral.parseval_mse(a, o, dD, dM, nx, ny)
            for a, o in zip(Yb, Ob)]))

    mses = torch.zeros(iters + 1, dtype=x.dtype, device=x.device)
    mses[0] = batch_mse(Y, O)
    Dc, Df, Db, Dp = mom
    # Cf/Ff ride the loop: the gradient pass needs the CURRENT weights'
    # spectra, which are the post-update spectra of the previous forward
    Cf = dft.kernel_spectrum(c, nx, ny)
    Ff = dft.kernel_spectrum(f, nx, ny)
    for i in range(iters):
        dc, df, db, dp = _gradient_k_io_batch(X, Y, O, Cf, Ff, b, nx, ny,
                                              axis_name)
        gc = dft.kernel_project(dc, nk, nl, nx, ny)
        gf = dft.kernel_project(df, nk, nl, nx, ny)
        if maxdiff:
            # multiobjective: reconstruction vs kernel diversity
            # (backprop_double, fft_backproplib.cu:657-704; w's set at 1252)
            from ..losses.losses import diversity_gradients
            cd, fd, bd, pd = diversity_gradients(c, f, b, p)
            gc, gf = w0 * gc - w1 * cd, w0 * gf - w1 * fd
            db, dp = w0 * db - w1 * bd, w0 * dp - w1 * pd
        c, Dc = burst_inertia(c, gc, Dc, del_eff, alpha)
        f, Df = burst_inertia(f, gf, Df, del_eff, alpha)
        b, Db = burst_inertia(b, db, Db, del_eff, alpha)
        p, Dp = burst_inertia(p, dp, Dp, del_eff, alpha)
        Cf = dft.kernel_spectrum(c, nx, ny)
        Ff = dft.kernel_spectrum(f, nx, ny)
        H = spectral.spectral_conv(X, Cf, b, nx, ny, scale_by_dm=scale_by_dm)
        O = spectral.spectral_conv(H, Ff, p, nx, ny, scale_by_dm=scale_by_dm)
        mses[i + 1] = batch_mse(Y, O)
    if axis_name is not None:
        # the pmean of each iteration's batch MSE, all in one all_reduce
        mses = collectives.pmean(mses, axis_name)
    return FFTBurstResult(c=c, f=f, b=b, p=p, mom=(Dc, Df, Db, Dp),
                          mses=mses)


@dft.ieee_f32()
def fft_burst_dp(x: torch.Tensor, expout: torch.Tensor | None,
                 out0: torch.Tensor | None, c: torch.Tensor, f: torch.Tensor,
                 b: torch.Tensor, p: torch.Tensor, mom: tuple | None = None,
                 *, lr: float = 0.2, alpha: float = 0.9, iters: int = 100,
                 scale_by_dm: bool = True, use_pallas: bool | None = None,
                 maxdiff: bool = False, w0: float = 1.0, w1: float = 10.0,
                 reanchor_every: int | None = None,
                 pallas_windows=None) -> FFTBurstResult:
    """Single-device batched burst: ``x/expout/out0`` are ``[B, D, h, w]``.

    ``expout=None`` trains against the input itself.  ``maxdiff`` enables
    the multiobjective kernel-diversity combination; ``reanchor_every``
    resets the cancellation floor on long bursts.

    ``use_pallas`` (the JAX package's name): ``True`` selects the
    **correlation-space** body (:func:`~spectralae_torch.train.fft_corr.
    burst_corr`, whose fused precompute runs K4 on the card), ``False`` the
    ω-space body (cross-validation); ``None`` means ``x.is_cuda``.  An
    explicit ``reanchor_every`` or ``pallas_windows`` selects the corr body.
    """
    if pallas_windows is not None and out0 is not None:
        raise ValueError("pallas_windows only exists on the fused-anchor "
                         "precompute (out0=None)")
    if use_pallas is False and reanchor_every is not None:
        raise ValueError("reanchor_every requires the correlation-space "
                         "body (use_pallas=False selects the ω-space "
                         "cross-validation body, which cannot reanchor)")
    if use_pallas is None:
        use_pallas = x.is_cuda
    corr = (use_pallas or reanchor_every is not None
            or pallas_windows is not None)
    if expout is None and not corr:
        expout = x  # the ω-space body has no None handling
    if mom is None:
        mom = zero_moms(c, f, b, p)
    if corr:
        from .fft_corr import burst_corr
        return burst_corr(x, expout, out0, c, f, b, p, mom,
                          lr=lr, alpha=alpha, iters=iters,
                          maxdiff=maxdiff, w0=w0, w1=w1,
                          scale_by_dm=scale_by_dm,
                          reanchor_every=reanchor_every,
                          pallas_windows=pallas_windows)
    return _burst_dp_body(x, expout, out0, c, f, b, p, mom, lr=lr,
                          alpha=alpha, iters=iters, scale_by_dm=scale_by_dm,
                          axis_name=None, maxdiff=maxdiff, w0=w0, w1=w1)


def distributed_burst(mesh, *, lr: float = 0.2, alpha: float = 0.9,
                      iters: int = 100, scale_by_dm: bool = True,
                      use_pallas: bool | None = None,
                      maxdiff: bool = False, w0: float = 1.0,
                      w1: float = 10.0,
                      reanchor_every: int | None = None,
                      fused: bool = False,
                      pallas_windows=None):
    """A multi-rank burst over ``mesh``
    (:func:`spectralae_torch.dist.mesh.make_mesh`): the batch sharded over
    ``data``, the weights replicated.  The returned callable takes this
    rank's batch shard and returns the replicated result.

    The default body is the correlation-space burst
    (:mod:`spectralae_torch.train.fft_corr`): ONE pmean of the lag tensors
    over ``data`` replaces the per-iteration gradient collectives, and a
    ``model`` axis of more than one rank shards the resolution-dependent
    precompute; the iterations run replicated and collective-free.
    ``use_pallas`` selects the per-iteration ω-space bodies for
    cross-validation (True: :func:`~spectralae_torch.train.fft_pallas.
    burst_pallas_fused`, K5 then K7 on the card; False: the einsum body),
    their gradients pmean-ed over ``data`` every iteration.

    ``fused=True``: the fused-anchor contract (train against the input,
    anchor = the model's own forward, computed inside the precompute); the
    callable is ``run(x, c, f, b, p, mom=None)``, with ``pallas_windows``
    routing the precompute (under a model axis: K4 on row slabs unless
    False).  Otherwise ``run(x, expout, out0, c, f, b, p, mom=None)``.
    """
    if reanchor_every is not None and use_pallas is not None:
        # re-anchoring only exists on the corr body (use_pallas=None);
        # the ω-space cross-validation bodies would silently ignore it
        raise ValueError("reanchor_every requires the default "
                         "(correlation-space) body — drop use_pallas")
    if fused and use_pallas is not None:
        raise ValueError("fused anchoring only exists on the default "
                         "(correlation-space) body — drop use_pallas")
    if pallas_windows is not None and not fused:
        raise ValueError("pallas_windows selects the fused-anchor "
                         "precompute kernel — requires fused=True")
    from .fft_corr import burst_corr
    data = mesh.axis("data")
    model_axis = mesh.axis("model") if mesh.shape["model"] > 1 else None

    @dft.ieee_f32()
    def run_fused(x, c, f, b, p, mom=None):
        collectives.check_shards(x.shape[0], data)
        return burst_corr(x, None, None, c, f, b, p,
                          mom if mom is not None else zero_moms(c, f, b, p),
                          lr=lr, alpha=alpha, iters=iters,
                          scale_by_dm=scale_by_dm, maxdiff=maxdiff, w0=w0,
                          w1=w1, axis_name=data, model_axis=model_axis,
                          reanchor_every=reanchor_every,
                          pallas_windows=pallas_windows)

    if fused:
        return run_fused

    @dft.ieee_f32()
    def run(x, expout, out0, c, f, b, p, mom=None):
        collectives.check_shards(x.shape[0], data)
        if expout is None:
            expout = x
        mom = mom if mom is not None else zero_moms(c, f, b, p)
        kw = dict(lr=lr, alpha=alpha, iters=iters, scale_by_dm=scale_by_dm,
                  axis_name=data)
        if use_pallas is None:
            return burst_corr(x, expout, out0, c, f, b, p, mom,
                              maxdiff=maxdiff, w0=w0, w1=w1,
                              model_axis=model_axis,
                              reanchor_every=reanchor_every, **kw)
        if use_pallas:
            from .fft_pallas import burst_pallas_fused
            return burst_pallas_fused(x, expout, out0, c, f, b, p, mom, **kw)
        return _burst_dp_body(x, expout, out0, c, f, b, p, mom, **kw)

    return run
