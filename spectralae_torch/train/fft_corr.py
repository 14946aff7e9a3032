"""Correlation-space momentum burst: O(1)-per-iteration in resolution.

Port of :mod:`spectralae.train.fft_corr`.  The reference
burst (source/fft_backproplib.cu:1381-1511) freezes the input spectrum for
all 100 inner iterations.  Every per-iteration ω-space sum — the analytic
gradients (gradient_k_io, 395-475), their compact-support projection
(shrink_k, 535-565), and the Parseval MSE (calc_mse, 480-498) — is
therefore a fixed form in the *compact* kernels ``c, f`` whose
ω-dependence collapses onto a handful of cross-correlation tensors of the
frozen signals:

    XX[d,d'][v] = Σ_ω w(ω)·conj(X[d])·X[d']·e^{iθ_v(ω)}

with lags ``v`` ranging over sums/differences of kernel-tap offsets — a
[D, D, 4h+1, 4h+1] tensor (17×17 at 5×5 kernels).  After a one-time
precompute (:func:`corr_precompute_fused`, whose windows run through the
hand-written kernel K4 on the card, or :func:`corr_precompute`, through
K3), each inner iteration is a few small
einsums over [M, D, P]-sized operands — independent of resolution AND batch
(batched bursts average the correlation tensors up front, giving
``fft_burst_dp`` semantics).

**Anchored decomposition (precision).**  With K the composed kernel (f ∗ c
summed over m) and K₀ its value at burst entry, the continuum error splits
exactly as

    E = (O₀ − Y)  +  (s1·K̂₀X − O₀)  +  s1·ΔK̂X ,   ΔK = K − K₀

whose first two parts are precomputed **bin-wise** as lag tensors XE0 and
XG0, so every cancellation happens at *initial-error* scale: gradients and
MSE stay accurate until the error drops ~1e6× below its start.

The lag gathers/scatters are static one-hot maps applied as dense float32
matmuls (as in the JAX package), so every entry point here runs its
products in IEEE float32: TF32 would drop about 10 bits of them.  DC-bin
bias injections (conv_k, cu:183-184) are exact scalar corrections.

The fused precompute's ``"fft"``/``"fft-bf16"`` routes take the signal
spectra from the hand-written four-step rfft2
(:mod:`spectralae_torch.ops.fft_kernels`) in its mixed bin order, which K4
gathers to natural order; its ``"pixel"`` route computes every quantity in
pixel space (:mod:`spectralae_torch.ops.pixel_corr`, no FFT).

**Data and model parallelism** (:func:`spectralae_torch.train.fft_dp.
distributed_burst`): ``axis_name`` (the data axis's process group, see
:mod:`spectralae_torch.dist.mesh`) pmeans the precompute's lag tensors
and scalars over the batch shards in one all_reduce, after which the
iterations run replicated and collective-free; ``model_axis`` splits the
precompute's resolution-sized work over the model ranks, with one
resolution-sized collective, the all_gather of the signal spectra.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..dist import collectives
from ..losses.losses import diversity_gradients
from ..ops import dft, spectral
from ..ops.fft_kernels import rfft2_mixed
from ..ops.pixel_corr import pixel_anchor_windows
from ..ops.window_kernels import (anchor_windows, anchor_windows_plain,
                                  corr_pair_windows)
from ..optim.update import burst_inertia
from .fft import FFTBurstResult, zero_moms


@functools.lru_cache(maxsize=None)
def _lag_maps(nk: int, nl: int):
    """Static index maps between tap-offset lags and gathered tensors.

    Taps: a ∈ [−hx, hx] × [−hy, hy].  Lag grids per axis: L2 = ±2h (pair
    sums and the composed-kernel support), V4 = ±4h (L2 differences).
    """
    hx, hy = nk // 2, nl // 2
    tx = np.arange(nk) - hx
    ty = np.arange(nl) - hy
    # flat tap list, P = nk*nl, order (kx, ky) row-major like kernels
    tpx = np.repeat(tx, nl)
    tpy = np.tile(ty, nk)
    w2x, w2y = 4 * hx + 1, 4 * hy + 1
    w4x, w4y = 8 * hx + 1, 8 * hy + 1

    def flat(ax, ay, hax, hay, wy):
        return (ax + hax) * wy + (ay + hay)

    def onehot(idx, n):
        m = np.zeros((idx.size, n), np.float32)
        m[np.arange(idx.size), idx.reshape(-1)] = 1.0
        return m

    # (p, q) tap pair -> L2 lag of tap_p + tap_q   [P·P]
    pair2lag = flat(tpx[:, None] + tpx[None, :],
                    tpy[:, None] + tpy[None, :],
                    2 * hx, 2 * hy, w2y).reshape(-1)
    # (L2, u) -> V4 index of L2 − u                [L2·L2]
    l2x = np.repeat(np.arange(w2x) - 2 * hx, w2y)
    l2y = np.tile(np.arange(w2y) - 2 * hy, w2x)
    xxd = flat(l2x[:, None] - l2x[None, :],
               l2y[:, None] - l2y[None, :], 4 * hx, 4 * hy, w4y)

    n2, n4 = w2x * w2y, w4x * w4y
    pair_oh = onehot(pair2lag, n2)
    return dict(
        g_scatter_pair=pair_oh,                 # [P², n2] scatter-sum
        g_pair=pair_oh.T,                       # [n2, P²] gather
        xxd_idx=xxd.reshape(-1).astype(np.int64),   # [n2·n2] V4 indices
        v4ext=(4 * hx, 4 * hy), l2ext=(2 * hx, 2 * hy),
        n2=n2, n4=n4)


@functools.lru_cache(maxsize=None)
def _maps_on(nk: int, nl: int, device: torch.device):
    """The one-hot maps and the XXd index map of :func:`_lag_maps` as
    tensors on ``device``."""
    maps = _lag_maps(nk, nl)
    with torch.inference_mode(False):
        return {k: torch.as_tensor(maps[k], device=device)
                for k in ("g_scatter_pair", "g_pair", "xxd_idx")}


# the separable restricted-iDFT lag-window bases live with the other DFT
# primitives (the window transform, _corr_windows, with the window kernels)
_lag_basis = dft.lag_basis


def _herm_w(nx: int, ny: int):
    return spectral._hermitian_weights(nx, ny)


def _shard(planes: torch.Tensor, model_axis):
    """Zero-pad a stack to whole chunks over the model ranks and take this
    rank's chunk (along dim 0); returns ``(chunk, rows a chunk)``."""
    nm = collectives.axis_size(model_axis)
    n = planes.shape[0]
    chunk = -(-n // nm)
    pad = planes.new_zeros((chunk * nm - n,) + tuple(planes.shape[1:]))
    mi = collectives.axis_index(model_axis)
    return torch.cat([planes, pad])[mi * chunk:(mi + 1) * chunk], chunk


def _gather(local: torch.Tensor, n: int, model_axis) -> torch.Tensor:
    """The model ranks' chunks in rank order, cut to the first ``n``."""
    return collectives.all_gather(local.contiguous(), model_axis)[:n]


def _pair_windows(X, Z, nx, ny, hx, hy, model_axis):
    """K3's windows ``[D, E, 2hx+1, 2hy+1]`` of ``conj(X)·Z``; under
    ``model_axis`` each rank takes a chunk of Z's channels and the
    window-sized results are gathered (the JAX package splits the same
    plane stack, fft_corr.py:252-269)."""
    if model_axis is None:
        return corr_pair_windows(X, Z, nx, ny, hx, hy)
    E = Z.shape[1]
    mine, _ = _shard(Z.transpose(0, 1), model_axis)
    win = corr_pair_windows(X, mine.transpose(0, 1).contiguous(), nx, ny,
                            hx, hy)                       # [D, chunk, ., .]
    return _gather(win.transpose(0, 1), E, model_axis).transpose(0, 1)


def _composed_taps(c0, f0, maps, dD, dM, P):
    """The composed anchor taps K₀ = f₀ ∗ c₀ summed over m, ``[D, D,
    4h+1, 4h+1]`` (``[e, d]`` order)."""
    hx2, hy2 = _lag_maps(c0.shape[-2], c0.shape[-1])["l2ext"]
    K2 = torch.einsum("emq,mdr->edqr", f0.reshape(dD, dM, P),
                      c0.reshape(dM, dD, P)).reshape(dD * dD, P * P)
    return (K2 @ maps["g_scatter_pair"]).reshape(dD, dD, 2 * hx2 + 1,
                                                 2 * hy2 + 1)


@dft.ieee_f32()
def corr_precompute(x, expout, out0, c0, f0, *, scale_by_dm=True,
                    axis_name=None, model_axis=None):
    """One-time correlation precompute for a frozen-input burst.

    Returns the batch-averaged lag tensors + scalars consumed by
    :func:`corr_iterate`: XX (input autocorrelation, V4 lags), XE0 and XG0
    (input vs initial-error / vs forward-anchor mismatch, L2 lags), the
    error-energy scalars, and the DC-bin scalars.  ``c0/f0`` must be the
    kernels the burst starts from (they define the anchor K₀).  The windows
    run through :func:`~spectralae_torch.ops.window_kernels.
    corr_pair_windows` (K3 for CUDA tensors): two launches per precompute.

    ``axis_name`` (the data axis's process group) pmeans the tensors over
    the batch shards; ``model_axis`` splits the window transforms' planes
    over the model ranks (each holds the whole shard) and gathers the
    windows.
    """
    nx, ny = x.shape[-2], x.shape[-1]
    dD = x.shape[-3]
    dM = c0.shape[0]
    nk, nl = c0.shape[-2], c0.shape[-1]
    lm = _lag_maps(nk, nl)
    maps = _maps_on(nk, nl, x.device)
    X = spectral.rfft2(x)                          # [B, D, nx, nyr]
    Y = spectral.rfft2(expout)
    O0 = spectral.rfft2(out0)
    E0 = O0 - Y
    # anchor mismatch G₀ = s1·K̂₀X − O₀, accumulated BIN-WISE through the
    # composed kernel K₀ = f₀ ∗ c₀
    P = nk * nl
    K0taps = _composed_taps(c0, f0, maps, dD, dM, P)
    K0f = dft.kernel_spectrum(K0taps, nx, ny)          # [D, D, nx, nyr]
    s1 = (1.0 / (dM * dD)) if scale_by_dm else 1.0
    O0fwd = torch.sum(K0f[None] * X[:, None], dim=2) * s1
    G0 = O0fwd - O0
    hx2, hy2 = lm["l2ext"]
    hx4, hy4 = lm["v4ext"]
    # batch-averaged lag windows of conj(X)·X (±4h) and conj(X)·[E₀ G₀]
    # (±2h) through K3 (its plain version, the JAX package's XLA
    # formulation, for CPU tensors)
    XX = _pair_windows(X, X, nx, ny, hx4, hy4, model_axis).reshape(
        dD, dD, -1)
    win_eg = _pair_windows(X, torch.cat([E0, G0], dim=1), nx, ny, hx2, hy2,
                           model_axis).reshape(dD, 2 * dD, -1)
    XE0, XG0 = win_eg[:, :dD], win_eg[:, dD:]
    wv = torch.as_tensor(_herm_w(nx, ny), device=x.device)

    def energy(a, b):
        return torch.mean(torch.sum((a.real * b.real + a.imag * b.imag) * wv,
                                    dim=(-3, -2, -1)))
    # DC scalars (bin 0 of real-signal spectra is real); batch-averaged
    out = dict(XX=XX, XE0=XE0, XG0=XG0, E0E0=energy(E0, E0),
               GG0=energy(G0, G0), EG0=energy(E0, G0),
               X0=torch.mean(X[:, :, 0, 0].real, dim=0),
               E00=torch.mean(E0[:, :, 0, 0].real, dim=0),
               G00=torch.mean(G0[:, :, 0, 0].real, dim=0))
    if axis_name is not None:
        out = collectives.pmean(out, axis_name)
    return out


@dft.ieee_f32()
def corr_precompute_fused(x, c0, f0, b0, p0, *, scale_by_dm=True,
                          axis_name=None, model_axis=None,
                          pallas_windows=None):
    """Precompute for the case ``expout = x`` AND ``out0 = the model's own
    two-stage forward of x`` (every steady-state streaming call site).

    When the anchor output is *exactly* the model forward, the anchor
    mismatch ``G₀ = s1·K̂₀X − O₀`` collapses to the DC-only bias injection
    (conv_k adds biases at the zero bin only, fft_backproplib.cu:183-184),
    so relative to :func:`corr_precompute` this drops the ``rfft2(out0)``
    and the XG0 plane products, while producing the **same T dict** for
    :func:`corr_iterate` with the same anchoring precision.

    ``pallas_windows`` routes the windows:

    - ``None`` or ``True``: :func:`~spectralae_torch.ops.window_kernels.
      anchor_windows` — the hand-written kernel K4 for CUDA tensors at every
      size, its plain version for CPU tensors;
    - ``"bf16"``: the same, on signal planes rounded to bf16 (the plain
      version rounds them the same way on the CPU);
    - ``False``: the plain version (the JAX package's XLA formulation) on
      any device;
    - ``"fft"``: the signal spectra from the four-step rfft2
      (:func:`~spectralae_torch.ops.fft_kernels.rfft2_mixed`, its kernels
      for CUDA tensors) in mixed bin order, float32 planes at the "high"
      tier (bf16×3 products on the card), into
      ``anchor_windows(mixed=True)``;
    - ``"fft-bf16"``: the same with the planes stored bf16, at the
      "default" tier (bf16 operands);
    - ``"pixel"``: every quantity in pixel space, no FFT
      (:func:`spectralae_torch.ops.pixel_corr.pixel_anchor_windows`, plain
      PyTorch on any device).

    ``axis_name`` (the data axis's process group) pmeans the returned
    tensors over the batch shards in one all_reduce.  ``model_axis``
    (tensor parallelism) shards the whole resolution-sized pipeline over
    the model ranks: each transforms its share of the ``B·D`` signal
    planes, one all_gather of the half-spectra gives every rank the whole
    ``X``, and then

    K4 runs on this rank's x-row slab (``anchor_windows(row_slab=...)``;
    its plain version for ``False``), the slabs' partial windows and
    ``Σw|EG|²`` are psum-ed, and the DC scalars are computed directly.

    ``"pixel"``, ``"fft"`` and ``"fft-bf16"`` have no model-sharded form:
    they raise under ``model_axis``, as in the JAX package.
    """
    if pallas_windows not in (None, True, False, "bf16", "fft", "fft-bf16",
                              "pixel"):
        raise ValueError(f"pallas_windows={pallas_windows!r} is not one of "
                         "None, True, False, 'bf16', 'fft', 'fft-bf16', "
                         "'pixel'")
    if pallas_windows in ("pixel", "fft", "fft-bf16") \
            and model_axis is not None:
        raise ValueError(
            f"pallas_windows={pallas_windows!r} has no model-sharded "
            "variant — use the spectral kernel (True) under tensor "
            "parallelism")
    nx, ny = x.shape[-2], x.shape[-1]
    dD = x.shape[-3]
    dM = c0.shape[0]
    nk, nl = c0.shape[-2], c0.shape[-1]
    hx2, hy2 = _lag_maps(nk, nl)["l2ext"]
    P = nk * nl
    s1 = (1.0 / (dM * dD)) if scale_by_dm else 1.0
    s2 = (1.0 / dD) if scale_by_dm else 1.0
    norm = float(nx * ny)
    K0taps = _composed_taps(c0, f0, _maps_on(nk, nl, x.device), dD, dM, P)
    # DC bias offset of the true forward vs the continuum: dE0[e] =
    # norm·(s2·Σ_m f̂(0)·b + p)  (the only place out0 differed)
    fs0 = torch.sum(f0.reshape(dD, dM, P), dim=-1)      # [D, M]
    dE0 = norm * (s2 * (fs0 @ b0) + p0)                 # [D]
    if pallas_windows == "pixel":
        # FFT-free: every precompute quantity directly in pixel space (the
        # same anchoring-precision contract as the spectral routes)
        XXw, EGw, SEG, E_cont0, X0 = pixel_anchor_windows(x, K0taps, hx2,
                                                         hy2, s1)
    elif model_axis is not None:
        XXw, EGw, SEG, X0, E_cont0 = _tp_fused_windows(
            x, K0taps, nx, ny, hx2, hy2, s1, model_axis, pallas_windows)
    elif pallas_windows in ("fft", "fft-bf16"):
        # the spectra in the four-step FFT's mixed bin order; K4 gathers
        # them to natural order.  "fft" keeps float32 planes at the "high"
        # tier (bf16x3, ~3e-6 transform); "fft-bf16" stores bf16 planes at
        # "default" (spectralae/train/fft_corr.py:436-442, :458-462)
        fast = pallas_windows == "fft-bf16"
        Xre, Xim = rfft2_mixed(x, precision="default" if fast else "high",
                               out_dtype=torch.bfloat16 if fast else None)
        XXw, EGw, SEG, E_cont0 = anchor_windows(
            (Xre, Xim), K0taps, nx, ny, hx2, hy2, s1, mixed=True)
        # the DC bin stays at (row 0, lane 0) in mixed order
        X0 = torch.mean(Xre[:, :, 0, 0].float(), dim=0)
    else:
        X = spectral.rfft2(x)                           # [B, D, nx, nyr]
        if pallas_windows is False:
            XXw, EGw, SEG, E_cont0 = anchor_windows_plain(
                X, K0taps, nx, ny, hx2, hy2, s1)
        else:
            XXw, EGw, SEG, E_cont0 = anchor_windows(
                X, K0taps, nx, ny, hx2, hy2, s1,
                signal_dtype=(torch.bfloat16 if pallas_windows == "bf16"
                              else None))
        X0 = torch.mean(X[:, :, 0, 0].real, dim=0)      # [D]
    XX = XXw.reshape(dD, dD, -1)
    EGwin = EGw.reshape(dD, dD, -1)
    # reconstruct the E₀/G₀ split exactly: G₀ = −dE0 at DC only, so its
    # lag windows are the constant −X0[d]·dE0[e] (w(DC)=1) and its
    # energies are pure scalar corrections
    dc_lag = X0[:, None, None] * dE0[None, :, None]     # [d, e, 1]
    out = dict(XX=XX, XE0=EGwin + dc_lag,
               XG0=(-dc_lag).expand(EGwin.shape),
               E0E0=SEG + torch.sum(2.0 * E_cont0 * dE0 + dE0 * dE0),
               GG0=torch.sum(dE0 * dE0),
               EG0=-torch.sum((E_cont0 + dE0) * dE0),
               X0=X0, E00=E_cont0 + dE0, G00=-dE0)
    if axis_name is not None:
        out = collectives.pmean(out, axis_name)
    return out


def _tp_fused_windows(x, K0taps, nx, ny, hx2, hy2, s1, model_axis,
                      pallas_windows):
    """The model-sharded fused precompute (fft_corr.py:528-582): the
    signal planes transformed a share a rank, one all_gather of the
    half-spectra, then K4 (its plain version for ``pallas_windows=False``)
    on this rank's x-row slab with the partials psum-ed; returns
    ``(XXw, EGw, SEG, X0, E_cont0)``."""
    B, dD = x.shape[0], x.shape[-3]
    nyr = ny // 2 + 1
    planes, _ = _shard(x.reshape(B * dD, nx, ny), model_axis)
    X = _gather(spectral.rfft2(planes), B * dD, model_axis).reshape(
        B, dD, nx, nyr)
    # every rank holds the whole X and runs K4 on its slab of x-rows
    # (zero-padded past nx); the DC scalars are computed directly (K̂₀ at
    # ω = 0 is the plain tap sum): the kernel's e0 is the slab's own
    nm = collectives.axis_size(model_axis)
    chunk_x = -(-nx // nm)
    row0 = collectives.axis_index(model_axis) * chunk_x
    Xl = X[:, :, row0:row0 + chunk_x]
    if Xl.shape[-2] < chunk_x:
        Xl = torch.cat([Xl, Xl.new_zeros((B, dD, chunk_x - Xl.shape[-2],
                                          nyr))], dim=2)
    windows = anchor_windows_plain if pallas_windows is False \
        else anchor_windows
    XXw, EGw, SEGl, _ = windows(
        Xl.contiguous(), K0taps, nx, ny, hx2, hy2, s1, row_slab=row0,
        signal_dtype=(torch.bfloat16 if pallas_windows == "bf16" else None))
    XXw, EGw, SEG = collectives.psum([XXw, EGw, SEGl], model_axis)
    Xdc = X[:, :, 0, 0].real                             # [B, D]
    ksum = torch.sum(K0taps, dim=(-2, -1))               # [e, d]
    # near-total cancellation once trained: the same anchoring-precision
    # invariant as the EG contraction (float32 products)
    E_cont0 = torch.mean(s1 * torch.einsum("ed,bd->be", ksum, Xdc) - Xdc,
                         dim=0)
    return XXw, EGw, SEG, torch.mean(Xdc, dim=0), E_cont0


@functools.lru_cache(maxsize=None)
def _ext_scales(dM: int, dD: int, P: int, ab: float, s1: float,
                device: torch.device):
    """SCc, SCf (entry scale of the clipped step) and GMc (gradient-side
    rescale of the carried c̃) for the extended bias channel."""
    p0 = P // 2
    SCc = np.zeros((dM + 1, dD + 1, P), np.float32)
    SCc[:dM, :dD, :] = 1.0
    SCc[:dM, dD, p0] = ab
    SCf = np.zeros((dD, dM + 1, P), np.float32)
    SCf[:, :dM, :] = 1.0
    SCf[:, dM, p0] = 1.0
    GMc = np.ones((dM + 1, dD + 1, P), np.float32)
    GMc[:dM, dD, p0] = 1.0 / ab
    GMc[dM, dD, p0] = s1
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, device=device)
                     for a in (SCc, SCf, GMc))


@dft.ieee_f32()
def corr_iterate(T, c, f, b, p, mom=None, *, nx, ny,
                 lr=0.2, alpha=0.9, iters=100, maxdiff=False,
                 w0=1.0, w1=10.0, scale_by_dm=True,
                 vary_axes=()) -> FFTBurstResult:
    """Run the burst's inner loop on precomputed correlation tensors.

    ``c/f/b/p`` must be the same initial weights given to
    :func:`corr_precompute` (they are the anchor).  The iterations need no
    collective: a distributed burst's precompute has already reduced ``T``
    over the ranks.  ``vary_axes`` is the JAX package's carry-type mark for
    a model-sharded precompute under ``shard_map``; PyTorch tensors carry
    no such mark, so it changes nothing here.
    """
    dM, dD, nk, nl = c.shape
    P = nk * nl
    dd = dD * dD
    norm = float(nx * ny)
    n_norm = norm * 2.0 * dM * dD * nx * ny
    mse_norm = 1.0 / (dD * nx * ny) / (2 * dM * nx * ny)
    del_eff = 0.1 * lr
    s1 = (1.0 / (dM * dD)) if scale_by_dm else 1.0
    s2 = (1.0 / dD) if scale_by_dm else 1.0
    lm = _lag_maps(nk, nl)
    maps = _maps_on(nk, nl, c.device)
    n2, n4 = lm["n2"], lm["n4"]
    XXf = T["XX"].reshape(dD, dD, n4)
    XE0f = T["XE0"].reshape(dD, dD, n2)          # [d (X̄), d' (E₀), L2]
    XG0f = T["XG0"].reshape(dD, dD, n2)
    E0E0, GG0, EG0 = T["E0E0"], T["GG0"], T["EG0"]
    X0, E00, G00 = T["X0"], T["E00"], T["G00"]
    g_scatter = maps["g_scatter_pair"]                    # [P², n2]
    g_pair = maps["g_pair"]                               # [n2, P²]
    XE0pair = (XE0f.reshape(dd, n2) @ g_pair).reshape(dD, dD, P, P)

    if mom is None:
        mom = zero_moms(c, f, b, p)
    kshape_c, kshape_f = c.shape, f.shape
    c = c.reshape(dM, dD, P)
    f = f.reshape(dD, dM, P)
    mom = (mom[0].reshape(dM, dD, P), mom[1].reshape(dD, dM, P),
           mom[2], mom[3])

    # ---- bias-as-tap extended channels -----------------------------
    # The DC bias injections are a convolution against a CONSTANT input
    # channel (spectrum norm·δ_DC).  c̃ gains a bias column (scale s2/s1 =
    # dM, so the composed DC comes out right) and a frozen constant-maker
    # row (1/s1 at the center tap), f̃ the decoder-bias column; the lag
    # tensors extend with constant rows/columns (the DC exponential is
    # lag-independent), so the gradients of b and p fall out of the same
    # einsums as the tap gradients.  The gradient einsum for gf weights the
    # bias channel by plain b and the maker row by 1 (the reference's
    # no-/M hidden, cu:438-455): GMc rescales the carried c̃ for it.  The
    # update is the reference's per-parameter normalized step (backprop_d,
    # cu:605-652), dw = SC·[(1−α)·lr·g/max(|g|, 10)] + α·mom, with SC the
    # entry scale (ab on the c̃ bias column, 0 on frozen entries).
    dDe = dD + 1
    p0 = P // 2                   # the (0,0) tap carries the biases
    ab = s2 / s1                  # bias-column scale: c̃[m,D,p0] = ab·b
    dde = dD * dDe

    def embed_c(cc, bb, col_scale, mk_row=False):
        col = cc.new_zeros((dM, 1, P))
        col[:, 0, p0] = col_scale * bb
        row = cc.new_zeros((1, dDe, P))
        if mk_row:
            row[0, dD, p0] = 1.0 / s1
        return torch.cat([torch.cat([cc, col], dim=1), row], dim=0)

    def embed_f(ff, pp):
        col = ff.new_zeros((dD, 1, P))
        col[:, 0, p0] = pp
        return torch.cat([ff, col], dim=1)                # [dD, dMe, P]

    SCc, SCf, GMc = _ext_scales(dM, dD, P, ab, s1, c.device)

    # extended static tensors: the constant channel's correlations are
    # lag-independent DC products (w(DC)=1, e^{i·0·v}=1)
    dE0 = norm * (s2 * (torch.sum(f, dim=-1) @ b) + p)     # initial biases
    X0e = torch.cat([X0, X0.new_full((1,), norm)])         # [dDe]
    XXe = torch.cat([
        torch.cat([XXf, (norm * X0)[:, None, None].expand(dD, 1, n4)],
                  dim=1),
        (norm * X0e)[None, :, None].expand(1, dDe, n4),
    ], dim=0)                                              # [dDe, dDe, n4]
    # XX̃ at L2 differences: a gather (exact, as the one-hot product is)
    XXd = XXe.reshape(dDe * dDe, n4).index_select(
        1, maps["xxd_idx"]).reshape(dDe, dDe, n2, n2)
    # windows of the extended anchor error Ẽ₀ = s1·K̃̂₀X̃ − Y
    E0full = torch.cat([
        XE0f + XG0f + X0[:, None, None] * dE0[None, :, None],
        (norm * (E00 + G00 + dE0))[None, :, None].expand(1, dD, n2),
    ], dim=0)                                              # [d̃, e, L2]
    E0t = E0full.permute(1, 0, 2)                          # [e, d̃, L2]
    E0E0ext = (E0E0 + 2.0 * EG0 + GG0
               + torch.sum((2.0 * (E00 + G00) + dE0) * dE0))

    def composed_kernel(cc, ff):
        """K̃[e,d̃][L2] = Σ_m̃ Σ_{q+r=u} f̃·c̃ (f̃ ∗ c̃); the (q,r)→u
        scatter-sum is a one-hot matmul."""
        K2 = torch.einsum("emq,mdr->edqr", ff, cc).reshape(dde, P * P)
        return (K2 @ g_scatter).reshape(dD, dDe, n2)

    # ---- iteration 0: gradients from the caller-provided O₀ ----
    # (the burst trains against the frozen first output, cu:1430-1441; it
    # uses the PROVIDED output's error, not the anchor forward's)
    gc0 = torch.einsum("emq,edpq->mdp", f, XE0pair.permute(1, 0, 2, 3))
    gf0 = torch.einsum("mdr,deqr->emq", c, XE0pair)
    gf0 = gf0 + (E00[:, None] * (norm * b)[None])[:, :, None]
    db0 = norm * (torch.sum(f, dim=-1).T @ E00)
    dp0 = norm * E00
    gc0, gf0, db0, dp0 = (t / n_norm for t in (gc0, gf0, db0, dp0))
    if maxdiff:
        cd, fd, bd, pd = diversity_gradients(
            c.reshape(kshape_c), f.reshape(kshape_f), b, p)
        gc0 = w0 * gc0 - w1 * cd.reshape(dM, dD, P)
        gf0 = w0 * gf0 - w1 * fd.reshape(dD, dM, P)
        db0 = w0 * db0 - w1 * bd
        dp0 = w0 * dp0 - w1 * pd

    c1_, Dc = burst_inertia(c, gc0, mom[0], del_eff, alpha)
    f1_, Df = burst_inertia(f, gf0, mom[1], del_eff, alpha)
    b1_, Db = burst_inertia(b, db0, mom[2], del_eff, alpha)
    p1_, Dp = burst_inertia(p, dp0, mom[3], del_eff, alpha)

    # the anchor K̃₀ is the extended composition of the INITIAL weights
    # (biases included — the anchor forward is the biased forward)
    K0e = composed_kernel(embed_c(c, b, ab, mk_row=True), embed_f(f, p))

    # iterations 1..iters: iteration i records ΔK̃_i (the post-update-i
    # forward's state) and, for i < iters, applies update i+1; the burst
    # applies exactly `iters` updates (the gradient of the final forward is
    # discarded, matching the ω-space semantics)
    cc, ff = embed_c(c1_, b1_, ab, mk_row=True), embed_f(f1_, p1_)
    Dce, Dfe = embed_c(Dc, Db, ab), embed_f(Df, Dp)
    rec = []
    for i in range(1, iters + 1):
        dK = composed_kernel(cc, ff) - K0e
        # the ⟨ΔK,·⟩ MSE contractions are batched over all iterations
        # after the loop, from the recorded ΔK̃ (cu:1463-1464)
        rec.append(dK)
        if i == iters:
            break
        # R(ΔK̃)[e,d̃][L2] = Σ_{c̃,u} ΔK̃[e,c̃,u]·XX̃[d̃,c̃][L2−u]
        R = torch.einsum("ecu,dcLu->edL", dK, XXd)         # [e,d̃,L2²]
        Tt = s1 * R + E0t
        Tg = (Tt.reshape(dde, n2) @ g_pair).reshape(dD, dDe, P, P)
        gc = torch.einsum("emq,edpq->mdp", ff, Tg) / n_norm  # [M̃,D̃,P]
        # gf contracts the SAME tensor in [d̃, e] orientation, with the
        # gradient-side embedding of c̃
        gf = torch.einsum("mdr,deqr->emq", GMc * cc,
                          Tg.permute(1, 0, 2, 3)) / n_norm   # [D,M̃,P]
        if maxdiff:
            cd, fd, bd, pd = diversity_gradients(
                cc[:dM, :dD].reshape(kshape_c),
                ff[:, :dM].reshape(kshape_f),
                cc[:dM, dD, p0] / ab, ff[:, dM, p0])
            gc = w0 * gc - w1 * embed_c(cd.reshape(dM, dD, P), bd, 1.0)
            gf = w0 * gf - w1 * embed_f(fd.reshape(dD, dM, P), pd)
        cc, Dce = burst_inertia(cc, gc, Dce, del_eff, alpha, scale=SCc)
        ff, Dfe = burst_inertia(ff, gf, Dfe, del_eff, alpha, scale=SCf)

    c_o, b_o = cc[:dM, :dD], cc[:dM, dD, p0] / ab
    f_o, p_o = ff[:, :dM], ff[:, dM, p0]
    Dc, Db = Dce[:dM, :dD], Dce[:dM, dD, p0] / ab
    Df, Dp = Dfe[:, :dM], Dfe[:, dM, p0]

    # ---- Parseval MSE trajectory from the recorded state (batched over
    # all iterations; exactly the in-loop formula, cu:1463-1464) ----
    mses = [(E0E0 * mse_norm)[None]]
    if rec:
        dKs = torch.stack(rec)                             # [i, e, d̃, L2]
        Rs = torch.einsum("iecu,dcLu->iedL", dKs, XXd)
        mse_raw = (E0E0ext
                   + 2.0 * s1 * torch.einsum("iecu,ceu->i", dKs, E0full)
                   + s1 * s1 * torch.einsum("iedu,iedu->i", dKs, Rs))
        mses.append(mse_raw * mse_norm)
    return FFTBurstResult(
        c=c_o.reshape(kshape_c), f=f_o.reshape(kshape_f), b=b_o, p=p_o,
        mom=(Dc.reshape(kshape_c), Df.reshape(kshape_f), Db, Dp),
        mses=torch.cat(mses))


def _true_forward(x, c, f, b, p, scale_by_dm):
    """The biased two-stage forward of the burst's internal model, in
    pixel space — the reference's output recompute (cu:1460-1461) followed
    by its inverse transform.  Used as the next segment's O₀ when
    re-anchoring an explicit-``out0`` burst."""
    nx, ny = x.shape[-2], x.shape[-1]
    X = spectral.rfft2(x)
    Cf = dft.kernel_spectrum(c, nx, ny)
    Ff = dft.kernel_spectrum(f, nx, ny)
    H = spectral.spectral_conv(X, Cf, b, nx, ny, scale_by_dm=scale_by_dm)
    O = spectral.spectral_conv(H, Ff, p, nx, ny, scale_by_dm=scale_by_dm)
    return spectral.irfft2(O, (nx, ny))


@dft.ieee_f32()
def burst_corr(x, expout, out0, c, f, b, p, mom=None, *,
               lr=0.2, alpha=0.9, iters=100, maxdiff=False,
               w0=1.0, w1=10.0, scale_by_dm=True,
               axis_name=None, model_axis=None,
               reanchor_every=None,
               pallas_windows=None) -> FFTBurstResult:
    """Correlation-space burst; semantics of ``fft_burst``/``fft_burst_dp``.

    ``x/expout/out0``: ``[D, h, w]`` or batched ``[B, D, h, w]`` (gradients
    batch-averaged).  ``expout=None`` means "train against the input
    itself" (every reference/engine/CLI call site).

    ``reanchor_every``: re-anchor the decomposition every R iterations by
    recomputing the true forward and fresh XE0/XG0 tensors — resets the
    float32 cancellation floor to the *current* error scale (each segment
    runs the identical reference recursion, so the segmented burst equals
    the unsegmented one in exact arithmetic).  One precompute per segment.

    ``out0=None``: fused anchoring — the anchor output is the model's own
    biased two-stage forward of ``x``, computed *inside* the precompute as
    exact DC scalars on top of the continuum (:func:`corr_precompute_fused`,
    whose windows run through K4 on the card; ``pallas_windows`` routes
    them).  Requires ``expout`` None/x.

    ``axis_name`` (the data axis's process group) pmeans the correlation
    tensors over the batch shards, and ``model_axis`` shards the
    precompute's transform planes over the model ranks (one precompute
    per segment, each with its collectives); the iterations then run
    replicated and collective-free.  ``x/expout/out0`` are then this
    rank's batch shard.
    """
    fused = out0 is None
    if fused and not (expout is None or expout is x):
        raise ValueError("out0=None (fused anchor forward) trains against "
                         "the input; pass expout=None")
    if pallas_windows is not None and not fused:
        raise ValueError("pallas_windows only exists on the fused-anchor "
                         "precompute (out0=None) — drop it or the "
                         "explicit out0")
    if expout is None:
        expout = x
    if x.dim() == 3:
        x, expout = x[None], expout[None]
        if not fused:
            out0 = out0[None]
    nx, ny = x.shape[-2], x.shape[-1]

    def precompute(out_cur, c, f, b, p):
        if out_cur is None:
            return corr_precompute_fused(x, c, f, b, p,
                                         scale_by_dm=scale_by_dm,
                                         axis_name=axis_name,
                                         model_axis=model_axis,
                                         pallas_windows=pallas_windows)
        return corr_precompute(x, expout, out_cur, c, f,
                               scale_by_dm=scale_by_dm, axis_name=axis_name,
                               model_axis=model_axis)

    if iters == 0:
        # zero updates: report mses[0] only (the ω-space paths' semantics)
        T0 = precompute(out0, c, f, b, p)
        mse_norm = 1.0 / (c.shape[1] * nx * ny) / (2 * c.shape[0] * nx * ny)
        return FFTBurstResult(c=c, f=f, b=b, p=p,
                              mom=mom if mom is not None
                              else zero_moms(c, f, b, p),
                              mses=(T0["E0E0"] * mse_norm)[None])

    def segment(out_cur, c, f, b, p, mom, seg_iters):
        T = precompute(out_cur, c, f, b, p)
        return corr_iterate(T, c, f, b, p, mom, nx=nx, ny=ny, lr=lr,
                            alpha=alpha, iters=seg_iters, maxdiff=maxdiff,
                            w0=w0, w1=w1, scale_by_dm=scale_by_dm)

    if not reanchor_every or reanchor_every >= iters:
        return segment(out0, c, f, b, p, mom, iters)

    out_cur = out0
    mses_parts = []
    left = iters
    while left > 0:
        seg = min(reanchor_every, left)
        r = segment(out_cur, c, f, b, p, mom, seg)
        c, f, b, p, mom = r.c, r.f, r.b, r.p, r.mom
        # the next segment's mses[0] re-measures the boundary forward —
        # drop the duplicate
        mses_parts.append(r.mses if not mses_parts else r.mses[1:])
        left -= seg
        if left > 0:
            # fused mode re-anchors inside the next precompute; the
            # unfused contract recomputes the true forward explicitly
            out_cur = (None if fused else
                       _true_forward(x, c, f, b, p, scale_by_dm))
    return FFTBurstResult(c=c, f=f, b=b, p=p, mom=mom,
                          mses=torch.cat(mses_parts))


#: the JAX package's jitted name for :func:`burst_corr` (PyTorch runs eagerly)
fft_burst_corr = burst_corr
