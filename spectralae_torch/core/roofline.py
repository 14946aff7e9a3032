"""Roofline accounting: FLOPs / HBM bytes per call vs the card's peaks.

Port of :mod:`spectralae.core.roofline`.  The reference ships no
utilization numbers at all (SURVEY.md §6 — its only perf claim is the
qualitative "much faster", the reference README.md:5-6).  This module
fills the empty "util" cell: every bench row reports its work and traffic
next to its time, so "bandwidth-bound" is a checked claim (flops/s and
bytes/s vs the card's peaks), not an assertion from timings.

Two sources, combined per row:

1. **A count of the call as it runs** (:func:`op_cost`): the flops of
   ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions,
   attention) plus the FFTs' (:func:`fft_flops`: 5·n·log2 n a complex
   transform of n points, half that a real one; FlopCounterMode has no
   formula for them), and the operand plus result bytes of every aten
   operation dispatched, counted under a ``TorchDispatchMode`` — the eager
   counterpart of XLA's per-fusion "bytes accessed".  Elementwise
   arithmetic counts no flops, so the flops are a lower bound, and the
   FFTs' convention is not XLA's (whose cost analysis has a formula of its
   own), so a row's flops compare with the JAX package's only roughly.
   Each hand-written kernel's wrapper is one opaque call
   (:func:`spectralae_torch._kernels.opaque`, seen through the hook this
   module sets while it counts): 0 flops, its operand and result bytes
   counted at the boundary, as XLA costs a Mosaic custom call — on the
   card, where it launches the kernel, and on the CPU, where it runs the
   plain version, alike.

2. **Analytic supplements for the kernels** (:func:`anchor_windows_cost`,
   :func:`pallas_rfft2_cost`): the count records each kernel call's
   operand shapes, and :func:`kernel_supplements` adds the arithmetic of
   every K4 call it saw (and of the B5 transform feeding a K4 call on
   mixed planes) from the kernel's shape algebra —
   :func:`cost_with_kernels`, the bench rows' cost.  The kernel's HBM
   traffic is its operand reads + output writes, which the opaque
   boundary already counts.

Peaks are NVIDIA's datasheet numbers for the card (dense bf16 tensor-core
throughput, no sparsity, and HBM bandwidth).  The port's float32 work never
runs on TF32 (the entry points switch it off), so it runs far below the
bf16 peak and ``pct_peak_flops`` is a *lower bound* on how busy the card
is; ``pct_peak_bw`` is the meaningful ceiling for this workload (the
large-N burst is bound by memory).

Caveats on ``pct_peak_bw``: the dispatch count adds every operation's
operand+result bytes, which OVERCOUNTS true HBM traffic where consecutive
operations hand a buffer over through the cache, and counts an in-place
update's buffer twice — so rows can legitimately report >100 %.  Read
pct_peak_bw ≳ 100 as "this call moves roughly its counted bytes at full
bandwidth" — i.e. bandwidth-saturated — not as a violation of physics.
The analytic byte bounds (:func:`spectral_conv_bytes`,
:func:`fft_step_bytes`, :func:`corr_burst_bytes`) can never exceed physics.

No scaling by a trip count: XLA costs a ``while``/``scan`` body once, so
the JAX package's bench multiplied it up; the port's loops are Python, and
the count sees every iteration.  :func:`corr_iter_flops` stays for callers
that cost a loop analytically.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels

# (name from nvidia-smi, model, dense bf16 peak FLOP/s, HBM bytes/s) —
# NVIDIA's H100 datasheet, no sparsity; most specific name first
_PEAKS = (
    ("H100 NVL", "NVIDIA H100 NVL", 835e12, 3.9e12),
    ("H100 PCIe", "NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("H100 80GB HBM3", "NVIDIA H100 SXM5 80 GB", 989e12, 3.35e12),
)


class Peaks(NamedTuple):
    name: str
    flops: float    # dense bf16 peak, FLOP/s
    hbm: float      # HBM bandwidth, bytes/s


def device_peaks(device=None) -> Peaks | None:
    """The card's peaks for ``device`` (a torch device, its string or
    index; default the current CUDA device), or None for a CPU device, a
    card the table does not name, or no CUDA at all.  Never raises."""
    try:
        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.cuda.current_device()
        elif not isinstance(device, int):
            device = torch.device(device)
            if device.type != "cuda":
                return None
        kind = torch.cuda.get_device_name(device)
    except Exception:
        return None
    for key, name, fl, bw in _PEAKS:
        if key in kind:
            return Peaks(name=name, flops=fl, hbm=bw)
    return None


# the FFTs FlopCounterMode has no formula for, by aten name: True for a
# complex-to-complex transform
_FFTS = {"_fft_c2c": True, "_fft_r2c": False, "_fft_c2r": False}


def fft_flops(name: str, args, out) -> float:
    """Flops of one aten FFT (``_fft_c2c``, ``_fft_r2c``, ``_fft_c2r``):
    5·n·log2 n for each complex transform of n points over the transformed
    dims, 2.5·n·log2 n for each real one (the usual convention, FFTW's),
    times the transforms in the batch; 0 for any other operation."""
    if name not in _FFTS:
        return 0.0
    x, dims = args[0], args[1]
    full = out if name == "_fft_c2r" else x     # the real side's shape
    n = 1
    for d in dims:
        n *= full.shape[d]
    if n <= 1:
        return 0.0
    per = (5.0 if _FFTS[name] else 2.5) * n * float(np.log2(n))
    return per * (full.numel() // n)


# operations that allocate and move no data
_NO_TRAFFIC = frozenset(("empty", "empty_strided", "empty_like",
                         "new_empty", "new_empty_strided"))


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_nbytes(t) for t in tree.values())
    return 0


class TensorMeta(NamedTuple):
    """A kernel operand as the count records it (the tensor is not kept)."""
    shape: tuple
    dtype: torch.dtype


def _meta(tree):
    if isinstance(tree, torch.Tensor):
        return TensorMeta(tuple(tree.shape), tree.dtype)
    if isinstance(tree, (tuple, list)):
        return tuple(_meta(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return tree


def _tally_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Tally(TorchDispatchMode):
        """Operand + result bytes of every aten operation (views and
        allocations move none) and the FFTs' flops (:func:`fft_flops`);
        and, as :data:`spectralae_torch._kernels.HOOK`, every kernel
        wrapper's call as one opaque call (:meth:`boundary`), recorded in
        ``calls`` as ``(name, args, kwargs)`` with each tensor a
        :class:`TensorMeta`."""

        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.fft_flops = 0.0
            self.calls = []
            self.inside = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            if not (getattr(func, "is_view", False)
                    or name in _NO_TRAFFIC):
                self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            self.fft_flops += fft_flops(name, args, out)
            return out

        def boundary(self, fn, args, kwargs):
            """A kernel wrapper's call as XLA costs a Mosaic custom call:
            its operand and result bytes counted at the boundary, and
            nothing it runs seen by the count (the dispatch modes are off
            while it runs), so the plain version's operations on a CPU
            tensor count no more than the launch on a CUDA one.  A wrapper
            called by another one is part of the outer call."""
            if self.inside:
                return fn(*args, **kwargs)
            from torch.utils._python_dispatch import _disable_current_modes
            self.inside = True
            try:
                with _disable_current_modes():
                    out = fn(*args, **kwargs)
            finally:
                self.inside = False
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            self.calls.append((fn.__name__, _meta(args), _meta(kwargs)))
            return out

    return Tally()


def _count(fn, args, kwargs) -> tuple[float, float, list]:
    from torch.utils.flop_counter import FlopCounterMode
    tally = _tally_mode()
    with FlopCounterMode(display=False) as flops, tally:
        _kernels.HOOK = tally.boundary
        try:
            fn(*args, **kwargs)
        finally:
            _kernels.HOOK = None
    return (float(flops.get_total_flops()) + tally.fft_flops,
            float(tally.bytes), tally.calls)


def op_cost(fn, *args, **kwargs) -> tuple[float | None, float | None]:
    """(flops, bytes) of ``fn(*args, **kwargs)``, counted as it runs once —
    the counterpart of the JAX package's ``compiled_cost``.

    Flops are ``FlopCounterMode``'s (matmuls, convolutions, attention, the
    backward included) plus the FFTs' (:func:`fft_flops`); bytes are the operand plus result bytes of every
    aten operation dispatched, which overcounts HBM traffic as XLA's
    "bytes accessed" does (module docstring).  A hand-written kernel's
    wrapper counts as one opaque call: 0 flops, its operand and result
    bytes (:func:`spectralae_torch._kernels.opaque`), and the K1 and K2
    routes (:func:`spectralae_torch._kernels.kernel_route`) take the kernels
    on the CPU too while the count runs — so a row's count is the same on
    the card and on the CPU.  Every iteration of a Python loop is counted:
    scale nothing by a trip count.  Returns (None, None) on any failure — a
    missing cost must never kill a bench run.
    """
    try:
        flops, nbytes, _ = _count(fn, args, kwargs)
        return flops, nbytes
    except Exception:
        return None, None


def kernel_supplements(calls) -> tuple[float, float]:
    """Analytic (flops, bytes) of the kernel calls a count recorded, which
    the count itself sees as 0 flops: each K4 call (``anchor_windows``)
    adds :func:`anchor_windows_cost`'s flops; one on the four-step FFT's
    mixed planes (the ``"fft"`` routes, where one B5 transform of the same
    signal feeds it) also adds :func:`pallas_rfft2_cost` and both
    functions' bytes, as the JAX package's ``[pallas-fft-bf16]`` rows do.
    """
    flops = nbytes = 0.0
    for name, args, kwargs in calls:
        if name != "anchor_windows":
            continue
        X, taps, nx, ny, hx2, hy2 = args[:6]
        mixed = kwargs.get("mixed", False)
        B, D = (X[0] if mixed else X).shape[:2]
        bf16 = (X[0].dtype == torch.bfloat16 if mixed
                else kwargs.get("signal_dtype") == torch.bfloat16)
        afl, aby = anchor_windows_cost(B, D, nx, ny, hx2, hy2,
                                       signal_bytes=2 if bf16 else 4)
        flops += afl
        if mixed:
            ffl, fby = pallas_rfft2_cost(B, D, nx, ny,
                                         out_bytes=2 if bf16 else 4)
            flops += ffl
            nbytes += fby + aby
    return flops, nbytes


def cost_with_kernels(fn, *args, **kwargs) -> tuple[float | None,
                                                     float | None]:
    """:func:`op_cost` of ``fn(*args, **kwargs)`` plus the
    :func:`kernel_supplements` of the kernel calls it made — the bench
    rows' cost.  (None, None) on any failure."""
    try:
        flops, nbytes, calls = _count(fn, args, kwargs)
        sfl, sby = kernel_supplements(calls)
    except Exception:
        return None, None
    return flops + sfl, nbytes + sby


def anchor_windows_cost(B: int, D: int, nx: int, ny: int,
                        hx2: int, hy2: int,
                        signal_bytes: int = 4) -> tuple[float, float]:
    """Analytic (flops, hbm_bytes) of one ``anchor_windows`` kernel call
    (K4, ``spectralae_torch/csrc/corr_windows.cu``).

    Per (batch, ω-bin) the kernel does (nk2 = 2hx2+1 composed-tap rows,
    vy2 = 2hy2+1 / vy4 = 4hy2+1 window cols):

    - anchor spectra x-stage: 4 dots of K=nk2 per (e,d) → 8·nk2·D²
    - EG accumulate (complex multiply-add): 8·D²
    - EG window products + y-stage dots: (6 + 8·vy2)·D²
    - XX products + y-stage dots on the d≤e pairs: (6 + 8·vy4)·D(D+1)/2
    - |EG|² + DC scalars: 4·D

    The x-stage window contractions cost 4·(vx·vy)·pairs per *row* —
    ~vy/nyr of the y-stage — and are dropped.  HBM traffic is one read of
    the split re/im signal spectra (``2·B·D·nx·nyr·signal_bytes``; pass
    ``signal_bytes=2`` for the bf16 streaming path) plus the tiny
    constant operands/outputs, dropped likewise.
    """
    nyr = ny // 2 + 1
    nk2 = 2 * hx2 + 1
    vy2 = 2 * hy2 + 1
    vy4 = 4 * hy2 + 1
    per_bin = (D * D * (8 * nk2 + 8 + 6 + 8 * vy2)
               + (D * (D + 1) // 2) * (6 + 8 * vy4)
               + 4 * D)
    flops = float(B * nx * nyr * per_bin)
    hbm = float(2 * B * D * nx * nyr * signal_bytes)
    return flops, hbm


def corr_iter_flops(D: int, M: int, nk: int, nl: int, iters: int) -> float:
    """Arithmetic of the correlation burst's inner loop body × iterations
    (``train/fft_corr.corr_iterate``), for a caller that costs the loop
    analytically (:func:`op_cost` already sees every iteration).

    Per iteration, on the bias-extended tape (dDe=D+1, dMe=M+1, P=nk·nl,
    n2=(4⌊nk/2⌋+1)(4⌊nl/2⌋+1) composed-support lags):

    - composed kernel: einsum [dD,dMe,P]×[dMe,dDe,P] + scatter
      [dde,P²]@[P²,n2]
    - R(ΔK): einsum over (e,c,u,d,L) → 2·dD·dDe²·n2²
    - Tg gather: [dde,n2]@[n2,P²]
    - gc/gf einsums: ≈ 2 × the composed-kernel einsum
    """
    dDe, dMe = D + 1, M + 1
    dde = D * dDe
    P = nk * nl
    n2 = (4 * (nk // 2) + 1) * (4 * (nl // 2) + 1)
    k2 = 2 * D * dMe * dDe * P * P
    per_iter = (k2                      # composed kernel einsum
                + 2 * dde * P * P * n2  # (q,r)→u scatter matmul
                + 2 * D * dDe * dDe * n2 * n2   # R(ΔK)
                + 2 * dde * n2 * P * P  # Tg gather matmul
                + 2 * k2)               # gc + gf
    return float(per_iter * iters)


def pallas_rfft2_cost(B: int, D: int, nx: int, ny: int,
                      out_bytes: int = 4,
                      max_m1: int | None = None) -> tuple[float, float]:
    """Analytic (flops, hbm_bytes) of one mixed-order four-step rfft2
    (B5: ``ops/fft_kernels.rfft2_mixed``, ``csrc/rfft2_mixed.cu``) over
    ``[B, D, nx, ny]`` real input — opaque to :func:`op_cost`.

    Matmul flops from the kernel shapes (2 flops per MAC; m1 = n/4,
    k1p = _k1p(n)):

    - real y-leaf: 12 dots [nx, m1]×[m1, k1p] per plane
    - complex y-leaf (wrapper recursion streams): 16 dots
    - x-leaf: 16 dots [m1, m1]×[m1, L] per plane-group
    - wrapper butterfly rounds: ~12 flops/element, one extra HBM
      read+write of the split planes each

    HBM: one read of x, the inter-stage split-plane write+read, the
    mixed-order write (×``out_bytes``), and the final y-group
    lane-transpose pass (same dtype as the output).
    """
    from ..ops.fft_kernels import _k1p, _MAX_M1
    if max_m1 is None:
        max_m1 = _MAX_M1
    BD = B * D
    plane = nx * (ny // 2 + 1)              # ~split-plane elements

    # ---- y-stage (transform length ny over nx rows per plane) ----
    flops, hbm = 0.0, float(BD * nx * ny * 4)          # read x (f32)
    n, rounds = ny, 0
    while n // 4 > max_m1:
        flops += 12.0 * BD * nx * n                    # butterfly
        hbm += 2 * 2 * BD * nx * n * 4                 # write+read ×2 planes
        n //= 4
        rounds += 1
    g = 4 ** rounds
    dots = 12 if rounds == 0 else 16                   # real vs complex leaf
    flops += dots * 2.0 * BD * g * nx * (n // 4) * _k1p(n)
    k1p_leaf = _k1p(n)
    L = 4 * g * k1p_leaf                               # total mixed lanes
    hbm += 2 * BD * nx * L * 4.0                       # y-stage write

    # ---- x-stage (transform length nx, lanes L per plane) ----
    hbm += 2 * BD * nx * L * 4.0                       # x-stage read
    n = nx
    while n // 4 > max_m1:
        flops += 12.0 * BD * L * n
        hbm += 2 * 2 * BD * n * L * 4
        n //= 4
    m1 = n // 4
    flops += 16 * 2.0 * BD * (nx // n) * m1 * m1 * L
    hbm += 2 * BD * nx * L * float(out_bytes)          # mixed write
    # final lane transpose (movedim): read + write
    hbm += 2 * 2 * BD * nx * L * float(out_bytes)
    del plane
    return flops, hbm


def spectral_conv_bytes(B: int, D: int, M: int, nx: int, ny: int) -> float:
    """Analytic HBM byte *bound* for one rfft2 → pointwise conv → irfft2
    round trip (the ``conv_spectral_*`` bench rows): every resolution-
    sized array counted once written + once read where it crosses an
    operation boundary (input read, X/kernel/Y spectra w+r as
    split-complex f32, output write).  True traffic can only be LOWER, so
    pct_peak_bw against this bound is an upper bound on utilization —
    unlike the dispatch count's bytes, it can never exceed physics."""
    nyr = ny // 2 + 1
    cplx = 8.0
    return float(B * D * nx * ny * 4            # x read
                 + 2 * B * D * nx * nyr * cplx  # X write+read
                 + 2 * M * D * nx * nyr * cplx  # kernel spectra w+r
                 + 2 * B * M * nx * nyr * cplx  # Y write+read
                 + B * M * nx * ny * 4)         # out write


def fft_step_bytes(B: int, D: int, M: int, nx: int, ny: int,
                   pairs: int) -> float:
    """Analytic HBM byte bound for one fwd+bwd ``train_step``
    (``modern_fft_step_*`` rows): forward traffic = the input/output
    planes plus each stage's activation spectra (write+read, split-
    complex) down the pooled pyramid and back up; backward ≈ 2× forward
    (re-read activations + write cotangents).  A bound, not an exact
    count."""
    nyr_of = lambda r: r // 2 + 1
    fwd = B * D * nx * ny * 4.0 + B * D * nx * ny * 4.0   # x read, recon w
    for s in range(pairs):
        r = nx >> (s + 1)                # resolution after encoder pool s
        din = D if s == 0 else M
        # encoder stage s: read in-spectra, write out-spectra (and the
        # mirrored decoder stage moves the same planes back up)
        stage = (B * din * r * nyr_of(r) * 8.0
                 + B * M * r * nyr_of(r) * 8.0)
        fwd += 2 * stage
    return float(3.0 * fwd)


def corr_burst_bytes(B: int, D: int, nx: int, ny: int, *,
                     fused: bool, signal_bytes: int = 4) -> float:
    """Analytic HBM byte bound for the correlation burst's precompute
    (``fft_burst_100_ms_*`` rows; the 100 iterations move only
    window-sized tensors).  Unfused path (``fused=False``): signal spectra
    write+read plus the [D², nx, nyr] XX and EG product planes
    (write + one read by the lag-window transforms).  Fused path: K4
    (``csrc/corr_windows.cu``) reads the split spectra once and the
    products never touch HBM."""
    nyr = ny // 2 + 1
    x_read = B * D * nx * ny * 4.0
    spectra = 2 * B * D * nx * nyr * 2 * float(signal_bytes)  # w+r, re+im
    if fused:
        return float(x_read + spectra)
    planes = 2 * (D * D) * nx * nyr * 8.0 * 2     # XX + EG, w+r each
    return float(x_read + spectra + B * planes)


def utilization(flops: float | None, bytes_: float | None,
                seconds: float, peaks: Peaks | None) -> dict:
    """Per-row utilization dict for the bench's details file."""
    out = {}
    if flops is not None:
        out["gflop"] = round(flops / 1e9, 3)
        out["gflops_per_s"] = round(flops / seconds / 1e9, 1)
        if peaks:
            out["pct_peak_flops"] = round(
                100.0 * flops / seconds / peaks.flops, 2)
    if bytes_ is not None:
        out["gb"] = round(bytes_ / 1e9, 3)
        out["gb_per_s"] = round(bytes_ / seconds / 1e9, 1)
        if peaks:
            out["pct_peak_bw"] = round(
                100.0 * bytes_ / seconds / peaks.hbm, 2)
    if peaks:
        out["peaks"] = f"{peaks.name}: {peaks.flops/1e12:.0f} TFLOP/s bf16, " \
                       f"{peaks.hbm/1e9:.0f} GB/s HBM"
    return out
