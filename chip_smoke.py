#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``spectralae_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Device: require CUDA; print the card's name and power limit; turn TF32
   off for matmuls and cuDNN, so every plain version runs in float32.
2. Build: compile the hand-written kernels from ``spectralae_torch/csrc``.
3. Kernels: K1 (``cmul_contract``) and K2 (``conv_valid``) against their
   plain PyTorch versions at the stage shapes of the reference's default
   3-pair net (D=3, M=10, 5x5) at 256^2 batch 8 and at 1024^2 batch 4 —
   forward, then the backward's launches (K1's two conjugated contractions,
   K2 as the data grad) and the autograd Functions' gradients against
   autograd through the plain path; norm-relative error, the profiler's
   device time beside the plain call's, the library call's (one einsum for
   K1, cuDNN for K2) and the bound, one line per shape; then the whole
   forward and the whole train step in both domains at both sizes: host
   time, device time and the kernels that take it, with the shape of each
   kernel launch of one 256^2 step recorded.
4. Serving: ``export`` and ``serve`` through the CLI in both domains, then
   an ``InferenceServer`` over HTTP for ``forward`` and ``encode`` in both
   domains, each response held against the same model run on the CPU
   (where the plain versions run); the kernels' launch counters are reset
   before this phase and must have grown in it.
5. Training: ``train`` through the CLI on the card at 256^2 batch 8 in both
   domains, with a checkpoint and a resume; the loss must fall, the resume
   must go on from the saved weights, the launch counters must grow by
   exactly the launches of one step per step, and a 3-step run must match
   the same run on the CPU in parameters, momentum and raw gradient.

The line before the last is a JSON object with each kernel's launches on
the two paths and per train step, its largest error, and its time, plain
time, bound and library time per 256^2 batch-8 train step (forward and
backward): the rows of phase 3 at the shapes of the launches one such step
made, summed; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

# norm-relative tolerances, each with its reason
TOL_K1 = 1e-6      # same float32 products, summed in another order
TOL_K2 = 1e-6      # the same, over D*nk*nl taps
TOL_K2_DW = 1e-5   # the weight grad sums B*H*W (up to 2^20) float32 products
TOL_FFT = 1e-4     # 6 stages of float32 FFTs (cuFFT vs pocketfft) + K1
TOL_COORD = 1e-5   # 6 float32 convs (K2 / cuDNN vs the CPU's), pooling
# the momentum after 3 steps is the last update step: clipped entries are
# +-lr(1-alpha) whatever the gradient's size, entries under GRAD_CLIP are
# g/GRAD_CLIP, so the step carries the absolute error of the small gradient
# entries, which float32 convs and FFTs summing 2^19 terms leave large
TOL_MOM = 1e-4
REPS = 20          # timed launches per measurement, after 3 warm-up ones
# the card's peaks for the bounds (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# the training phase: steps of the first run, then of the resumed one
TRAIN_STEPS, RESUME_STEPS = 20, 5
# hand-written kernel launches in one train step of the default net: K1 for
# 6 forward convs, 6 kernel-spectrum grads and 5 input-spectrum grads (the
# frames' spectra need none); K2 for the 2 routed forward convs (3->10,
# 10->3; their data grads go to F.conv2d unless PALLAS_DATA_GRAD is set)
K1_PER_FFT_STEP, K2_PER_COORD_STEP = 17, 2


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    wide = torch.complex128 if want.is_complex() else torch.float64
    got, want = got.to(wide), want.to(wide)
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def cuda_ms(fn) -> float:
    """Mean milliseconds of ``fn()`` over REPS launches, by CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def device_ms(fn) -> float:
    """Milliseconds the device spends in the kernels of one ``fn()``: the
    profiler's device time over REPS calls, whatever the host's pace."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / REPS / 1e3


def paired_ms(kernel, plain) -> tuple[float, float, float, float]:
    """Event times in the order plain, kernel, kernel, plain (their means),
    then the profiler's device times of kernel and plain."""
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, device_ms(kernel), device_ms(plain)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(a: int, k: int, b: int, w: int, bias: bool = False):
    """[A,K,W] x [K,B,W] -> [A,B,W] complex64: each operand read once, the
    output written once; 8 flops per complex multiply-add."""
    return bound_ms(8.0 * a * k * b * w,
                    8.0 * w * (a * k + k * b + a * b) + (4 * b if bias else 0))


def k2_bound(b: int, d: int, m: int, hp: int, wp: int, nk: int, nl: int):
    """Valid correlation [B,D,Hp,Wp] x [M,D,nk,nl] -> [B,M,H,W] float32."""
    h, wo = hp - nk + 1, wp - nl + 1
    return bound_ms(2.0 * b * m * d * nk * nl * h * wo,
                    4.0 * (b * d * hp * wp + m * d * nk * nl + b * m * h * wo))


def measure(label: str, got, want, kernel, plain, bound, tol: float, *,
            library=True, extra: str = "") -> dict:
    """Hold ``got`` against ``want``, time ``kernel`` against ``plain``,
    print one line, return the row.  ``library`` is the one PyTorch call
    that computes the same function: ``plain`` itself when True, else a
    call timed on its own."""
    err = rel_err(got, want)
    abs_err = float((got - want).abs().max())
    ev, plain_ev, ms, plain_ms = paired_ms(kernel, plain)
    ms, plain_ms = ms or ev, plain_ms or plain_ev
    if library is True:
        lib_ms, lib_txt = plain_ms, " (the library call)"
    else:
        lib_ms = device_ms(library) or cuda_ms(library)
        lib_txt = f" library {lib_ms:.4f} ms"
    print(f"{label}: rel {err:.3e} (tol {tol:g}{extra}) max_abs "
          f"{abs_err:.3e} device: kernel {ms:.4f} ms plain {plain_ms:.4f} "
          f"ms{lib_txt} bound {bound[0]:.4f} ms ({bound[1]}); events: "
          f"kernel {ev:.4f} ms plain {plain_ev:.4f} ms", flush=True)
    check(err <= tol, f"{label} disagrees: rel {err:.3e} > {tol:g}")
    return {"abs": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms}


def k1_key(p, q, conj_q: bool = False, bias=None) -> tuple:
    """What sets the work of one K1 launch: the operands' shapes, the
    conjugation and the bias."""
    return tuple(p.shape), tuple(q.shape), bool(conj_q), bias is not None


def k2_key(xpad, w) -> tuple:
    return tuple(xpad.shape), tuple(w.shape)


@contextlib.contextmanager
def launch_log():
    """Record the key of every kernel launch made inside the block, by
    kernel, calling through to the wrappers (which count the launches)."""
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import spectral_kernels as sk
    log = {"k1": [], "k2": []}
    k1, k2 = sk.cmul_contract, ck._valid_corr

    def k1_spy(p, q, **kw):
        log["k1"].append(k1_key(p, q, kw.get("conj_q", False),
                                kw.get("bias")))
        return k1(p, q, **kw)

    def k2_spy(xpad, w):
        log["k2"].append(k2_key(xpad, w))
        return k2(xpad, w)
    sk.cmul_contract, ck._valid_corr = k1_spy, k2_spy
    try:
        yield log
    finally:
        sk.cmul_contract, ck._valid_corr = k1, k2


def stage_shapes(nx: int, layers: int):
    """(spatial n, D, M) of each conv stage of the default net."""
    from spectralae_torch.core.config import Config
    from spectralae_torch.core.types import initial_spec
    cfg = Config(nx=nx, ny=nx)
    spec = initial_spec(cfg)
    for _ in range(layers - 1):
        spec = spec.add_pair(cfg.layer)
    return [(s.nx, s.d, s.m) for s in spec.stages]


def _grads_line(label: str, pairs, tol: float) -> float:
    """Print and check named (got, want, tol) gradient comparisons."""
    errs = [(name, rel_err(g, w), t or tol) for name, g, w, t in pairs]
    print(f"{label}: " + ", ".join(f"{n} rel {e:.3e} (tol {t:g})"
                                   for n, e, t in errs), flush=True)
    for name, e, t in errs:
        check(e <= t, f"{label}: {name} rel {e:.3e} > {t:g}")
    return max(float((g - w).abs().max()) for _, g, w, t in pairs
               if t is None)


def k1_shape(gen, n: int, batch: int, d: int, m: int) -> tuple[dict, float]:
    """K1 at one stage shape: the forward, the backward's dX and dC
    contractions, and SpectralConvFused's gradients against autograd
    through the plain einsum.  Returns the timed rows by launch key (each
    with its part of the step, forward or backward) and the largest
    absolute error.  The library call is one ``torch.einsum`` of the same
    operands, conjugated for dX and dC, without the 1/M scale and the DC
    bias (two passes of their own)."""
    from spectralae_torch.ops import dft, spectral
    from spectralae_torch.ops import spectral_kernels as sk
    nyr = n // 2 + 1
    w = n * nyr
    tag = f"{n}x{n} b{batch}"
    x = torch.randn(batch, d, n, n, device="cuda", generator=gen)
    X = torch.fft.rfft2(x).reshape(batch, d, w).contiguous()
    c = torch.rand(m, d, 5, 5, device="cuda", generator=gen) * 6 - 3
    C = dft.kernel_spectrum(c, n, n).reshape(m, d, w)
    b = torch.rand(m, device="cuda", generator=gen) * 6 - 3
    g = torch.randn(batch, m, w, dtype=torch.complex64, device="cuda",
                    generator=gen)
    rows = {}
    gt = g.transpose(0, 1)
    fwd = dict(p_scale=1.0 / m, bias=b, bias_scale=float(n * n))
    bwd = dict(p_scale=1.0 / m, conj_q=True)
    for part, label, p, q, kw, bound in (
            ("fwd", f"forward {tag} K={d} B={m}", X, C.transpose(0, 1), fwd,
             k1_bound(batch, d, m, w, bias=True)),
            ("bwd", f"dX {tag} K={m} B={d} (p=g, q=conj C)", g, C, bwd,
             k1_bound(batch, m, d, w)),
            ("bwd", f"dC {tag} K={batch} B={d} (p=g^T view, q=conj X)", gt,
             X, bwd, k1_bound(m, batch, d, w))):
        q_lib = q.conj() if kw.get("conj_q") else q
        row = measure(
            f"K1 cmul_contract {label}",
            sk.cmul_contract(p, q, **kw), sk.cmul_contract_plain(p, q, **kw),
            lambda: sk.cmul_contract(p, q, **kw),
            lambda: sk.cmul_contract_plain(p, q, **kw), bound, TOL_K1,
            library=lambda: torch.einsum("akw,kbw->abw", p, q_lib))
        rows[k1_key(p, q, kw.get("conj_q"), kw.get("bias"))] = dict(
            row, part=part)
    grads = []
    for conv in (sk.spectral_conv_fused, spectral.spectral_conv_einsum):
        leaves = [X.reshape(batch, d, n, nyr).clone().requires_grad_(),
                  C.reshape(m, d, n, nyr).clone().requires_grad_(),
                  b.clone().requires_grad_()]
        y = conv(*leaves, n, n)
        grads.append(torch.autograd.grad(y, leaves,
                                         g.reshape(batch, m, n, nyr)))
    abs_err = _grads_line(
        f"SpectralConvFused grads {tag} D={d} M={m} vs autograd through "
        "spectral_conv_einsum",
        [(name, got, want, None)
         for name, got, want in zip(("dX", "dC", "db"), *grads)], TOL_K1)
    return rows, max(abs_err, *(r["abs"] for r in rows.values()))


def k2_shape(gen, n: int, batch: int, d: int, m: int) -> tuple[dict, float]:
    """K2 at one stage shape: the forward, the data grad through K2 (the
    PALLAS_DATA_GRAD route) against F.conv2d's, and ConvValid's gradients
    against autograd through F.conv2d in float32 and float64.  Returns the
    timed rows by launch key and the largest absolute error."""
    import torch.nn.functional as F
    from spectralae_torch.ops import coord_kernels as ck
    tag = f"{n}x{n} b{batch}"
    routed = m * d <= 64
    note = "" if routed else " (not routed to K2 by coord.conv2d)"
    xpad = torch.randn(batch, d, n + 4, n + 4, device="cuda", generator=gen)
    c = torch.rand(m, d, 5, 5, device="cuda", generator=gen) * 6 - 3
    wt = c.flip((-2, -1)).contiguous()
    dy = torch.randn(batch, m, n, n, device="cuda", generator=gen)
    rows = {}
    got = ck.conv_valid(xpad, wt)
    err64 = rel_err(got, ck.conv_valid_plain(xpad.double(), wt.double()))
    check(err64 <= TOL_K2, f"K2 {tag} disagrees with float64: {err64:.3e}")
    rows[k2_key(xpad, wt)] = dict(measure(
        f"K2 conv_valid forward {tag} D={d} M={m} 5x5{note}", got,
        ck.conv_valid_plain(xpad, wt), lambda: ck.conv_valid(xpad, wt),
        lambda: ck.conv_valid_plain(xpad, wt),
        k2_bound(batch, d, m, n + 4, n + 4, 5, 5), TOL_K2,
        extra=f"; vs float64 {err64:.3e}"), part="fwd")
    # the data grad: dy padded by the taps, weights M/D-transposed and
    # flipped — a valid correlation with M input and D output channels
    dy_pad = F.pad(dy, (4, 4, 4, 4))
    wtt = wt.transpose(0, 1).flip((-2, -1)).contiguous()
    got = ck.conv_valid(dy_pad, wtt)
    err64 = rel_err(got, F.conv2d(dy_pad.double(), wtt.double()))
    check(err64 <= TOL_K2, f"K2 dx {tag} disagrees with float64: {err64:.3e}")
    rows[k2_key(dy_pad, wtt)] = dict(measure(
        f"K2 conv_valid data grad {tag} {m}->{d} at {n + 8}^2 "
        f"(PALLAS_DATA_GRAD route) vs F.conv2d", got,
        F.conv2d(dy_pad, wtt), lambda: ck.conv_valid(dy_pad, wtt),
        lambda: F.conv2d(dy_pad, wtt),
        k2_bound(batch, m, d, n + 8, n + 8, 5, 5), TOL_K2,
        extra=f"; vs float64 {err64:.3e}"), part="bwd")
    grads = {}
    for name, fn, dtype in (("fn", ck.conv_valid, torch.float32),
                            ("f32", F.conv2d, torch.float32),
                            ("f64", F.conv2d, torch.float64)):
        leaves = [xpad.to(dtype).requires_grad_(),
                  wt.to(dtype).requires_grad_()]
        grads[name] = torch.autograd.grad(fn(*leaves), leaves, dy.to(dtype))
    abs_err = _grads_line(
        f"ConvValid grads {tag} D={d} M={m} vs autograd through F.conv2d",
        [("dx", grads["fn"][0], grads["f32"][0], None),
         ("dw", grads["fn"][1], grads["f32"][1], None),
         ("dx vs float64", grads["fn"][0], grads["f64"][0], TOL_K2),
         ("dw vs float64", grads["fn"][1], grads["f64"][1], TOL_K2_DW)],
        TOL_K2)
    return rows, max(abs_err, *(r["abs"] for r in rows.values()))


def phase_kernels(gen: torch.Generator) -> tuple[dict, dict]:
    """Every stage shape at both sizes; returns each kernel's timed rows by
    launch key and its largest absolute error."""
    timed, errs = {"k1": {}, "k2": {}}, {"k1": 0.0, "k2": 0.0}
    for nx, batch in ((256, 8), (1024, 4)):
        for n, d, m in sorted(set(stage_shapes(nx, 3))):
            for kern, fn in (("k1", k1_shape), ("k2", k2_shape)):
                rows, err = fn(gen, n, batch, d, m)
                timed[kern].update(rows)
                errs[kern] = max(errs[kern], err)
    n, d, m = stage_shapes(256, 3)[-1]
    stage5 = timed["k2"][(8, m, n + 8, n + 8), (d, m, 5, 5)]
    print(f"stage-5 data grad at 256x256 b8 ({m}->{d} at {n + 8}^2): K2 "
          f"{stage5['ms']:.4f} ms, F.conv2d {stage5['plain_ms']:.4f} ms "
          f"(device); training routes it to F.conv2d "
          "(PALLAS_DATA_GRAD = False)", flush=True)
    return timed, errs


def per_step(timed: dict, launched: dict) -> dict:
    """Each kernel's ms, plain_ms, bound_ms and library_ms in one 256^2
    batch-8 train step, forward and backward: the sums of the rows timed
    at the keys of the launches such a step made (``launched``)."""
    out = {}
    for kern, keys in launched.items():
        tot = dict.fromkeys(("fwd_ms", "fwd_plain_ms", "bwd_ms",
                             "bwd_plain_ms", "ms", "plain_ms", "bound_ms",
                             "library_ms"), 0.0)
        for key in keys:
            r = timed[kern].get(key)
            check(r is not None, f"{kern}: a train step launched it at "
                  f"{key}, which no row of phase 3 timed")
            tot[f"{r['part']}_ms"] += r["ms"]
            tot[f"{r['part']}_plain_ms"] += r["plain_ms"]
            for name in ("ms", "plain_ms", "bound_ms", "library_ms"):
                tot[name] += r[name]
        tot["bound_by"] = max((timed[kern][k] for k in keys),
                              key=lambda r: r["bound_ms"])["bound_by"]
        out[kern] = tot
    return out


def _net(nx: int):
    from spectralae_torch.core.config import Config
    from spectralae_torch.core.types import init_params, initial_spec
    cfg = Config(nx=nx, ny=nx)
    spec = initial_spec(cfg)
    for _ in range(2):
        spec = spec.add_pair(cfg.layer)
    params = init_params(torch.Generator().manual_seed(0), spec,
                         cfg.layer.rmax, device="cuda")
    return params, spec


def _breakdown(label: str, fn, extra: str = "") -> None:
    """Host ms per call of ``fn`` (a synchronised loop), device ms, the
    device's busy share and the top device kernels; then, from a second
    profile that also traces the host, the host operations that take the
    most time of their own (inflated by the tracing, so only their order
    and shares are read)."""
    from torch.autograd import DeviceType
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / REPS * 1e3
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / REPS / 1e3, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    dev = sum(t for t, _ in rows)
    top = "; ".join(f"{name[:48]} {t:.4f}" for t, name in rows[:6])
    print(f"{label}: host {wall:.4f} ms, device {dev:.4f} ms (busy "
          f"{dev / wall:.1%}){extra}; top ms: {top}", flush=True)
    with torch.profiler.profile(activities=[acts.CPU]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    host = sorted(((e.self_cpu_time_total / REPS / 1e3, e.count // REPS,
                    e.key) for e in prof.key_averages()), reverse=True)
    total = sum(t for t, _, _ in host)
    top = "; ".join(f"{name[:40]} x{n} {t / total:.0%}"
                    for t, n, name in host[:8])
    print(f"{label}: host ops traced {total:.2f} ms per call, "
          f"{sum(n for _, n, _ in host)} op calls; top self time: {top}",
          flush=True)


def phase_forward() -> None:
    """Host and device time of whole forwards, and where the device time
    goes (kernels by name)."""
    from spectralae_torch.model import autoencoder as model
    for nx, batch in ((256, 8), (1024, 4)):
        params, spec = _net(nx)
        x = torch.rand(batch, 3, nx, nx, device="cuda") * 255
        for domain in ("fft", "coord"):
            if domain == "fft":
                def fwd():
                    return model.forward_fft(params, x, spec.scales)
            else:
                def fwd():
                    return model.forward_coord(params, x, spec.scales,
                                               tap_mode="ref_gpu")[-1]
            with torch.inference_mode():
                _breakdown(f"forward {domain} {nx}x{nx} b{batch}", fwd)


def phase_train_step() -> dict:
    """The same for whole train steps (forward, backward and the inertia
    update), with the kernels' launches per step and the peak memory.
    Returns the keys of the launches of one 256^2 batch-8 step, K1's from
    the fft domain and K2's from the coord domain."""
    from spectralae_torch.core.types import init_opt_state
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import spectral_kernels as sk
    from spectralae_torch.train.modern import train_step
    launched = {}
    for nx, batch in ((256, 8), (1024, 4)):
        params, spec = _net(nx)
        opt = init_opt_state(params)
        x = torch.rand(batch, 3, nx, nx, device="cuda") * 255
        for domain in ("fft", "coord"):
            def step():
                return train_step(params, opt, x, spec.scales, domain=domain)
            before = (sk.LAUNCHES, ck.LAUNCHES)
            with launch_log() as log:
                step()
            torch.cuda.synchronize()
            grew = (sk.LAUNCHES - before[0], ck.LAUNCHES - before[1])
            want = ((K1_PER_FFT_STEP, 0) if domain == "fft"
                    else (0, K2_PER_COORD_STEP))
            check(grew == want, f"train step {domain}: launched K1 "
                  f"{grew[0]}x, K2 {grew[1]}x; expected {want}")
            check(grew == (len(log["k1"]), len(log["k2"])),
                  f"train step {domain}: counted {grew}, logged "
                  f"{len(log['k1'])} and {len(log['k2'])} launches")
            if nx == 256:
                kern = "k1" if domain == "fft" else "k2"
                launched[kern] = log[kern]
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**20
            _breakdown(f"train step {domain} {nx}x{nx} b{batch}", step,
                       f", launches K1 {grew[0]} K2 {grew[1]}, peak "
                       f"{peak:.1f} MiB")
        # the data grad of the 10->3 stage through K2 adds one launch
        route, ck.PALLAS_DATA_GRAD = ck.PALLAS_DATA_GRAD, True
        try:
            before = ck.LAUNCHES
            train_step(params, opt, x, spec.scales, domain="coord")
            torch.cuda.synchronize()
            grew = ck.LAUNCHES - before
        finally:
            ck.PALLAS_DATA_GRAD = route
        print(f"train step coord {nx}x{nx} b{batch} with PALLAS_DATA_GRAD: "
              f"K2 launches {grew}", flush=True)
        check(grew == K2_PER_COORD_STEP + 1,
              f"coord step with the K2 data grad launched K2 {grew}x")
    return launched


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def phase_serving(tmp: Path) -> tuple[int, int]:
    from spectralae_torch.cli.main import main as cli
    from spectralae_torch.data import pipeline
    from spectralae_torch.io.export import ServingModel
    from spectralae_torch.io.server import InferenceServer
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import spectral_kernels as sk

    sk.LAUNCHES = 0
    ck.LAUNCHES = 0
    for domain in ("fft", "coord"):
        art = tmp / domain
        cli(["export", "--nx", "256", "--layers", "3", "--seed", "0",
             "--out", str(art), "--what", "both", "--domain", domain])
        cli(["serve", "--model", str(art / "forward"), "--steps", "3",
             "--batch", "8", "--outdir", str(tmp / "views")])
        tol = TOL_FFT if domain == "fft" else TOL_COORD
        for what in ("forward", "encode"):
            model = ServingModel.load(art / what, device="cuda")
            on_cpu = ServingModel.load(art / what, device="cpu")
            srv = InferenceServer(model, port=0)
            srv.start()
            try:
                base = f"http://127.0.0.1:{srv.port}"
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=60) as r:
                    health = json.loads(r.read())
                check(health["status"] == "ok" and health["what"] == what
                      and health["domain"] == domain, f"healthz: {health}")
                before = (sk.LAUNCHES, ck.LAUNCHES)
                worst = 0.0
                for req in range(3):
                    frames = np.stack([
                        pipeline.frame_to_tensor(f) for f in itertools.islice(
                            pipeline.synthetic_frames(256, 256,
                                                      seed=100 + req), 8)])
                    post = urllib.request.Request(
                        base + "/infer", data=_npy(frames), method="POST",
                        headers={"Content-Type":
                                 "application/octet-stream"})
                    with urllib.request.urlopen(post, timeout=120) as r:
                        got = np.load(io.BytesIO(r.read()))
                    want = on_cpu(frames)
                    check(got.shape == want.shape and got.dtype == np.float32,
                          f"{domain}/{what}: response {got.shape} "
                          f"{got.dtype}, expected {want.shape} float32")
                    check(bool(np.isfinite(got).all()),
                          f"{domain}/{what}: non-finite response")
                    err = rel_err(torch.from_numpy(got),
                                  torch.from_numpy(want))
                    worst = max(worst, err)
                    check(err <= tol, f"{domain}/{what} request {req}: "
                          f"rel {err:.3e} > {tol:g} against the CPU port")
                grew = (sk.LAUNCHES - before[0], ck.LAUNCHES - before[1])
            finally:
                srv.shutdown()
            print(f"served {domain}/{what} {tuple(got.shape)} x3 requests: "
                  f"rel vs CPU port {worst:.3e} (tol {tol:g}); launches "
                  f"during requests K1 +{grew[0]} K2 +{grew[1]}", flush=True)
            check(grew[0 if domain == "fft" else 1] > 0,
                  f"{domain}/{what}: its kernel was not launched")
    return sk.LAUNCHES, ck.LAUNCHES


def _cli_records(argv) -> list[dict]:
    """Run the port's CLI in this process; its JSON lines, parsed."""
    from spectralae_torch.cli.main import main as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def phase_training(tmp: Path) -> tuple[tuple[int, int], dict]:
    """``train`` on the card in both domains: TRAIN_STEPS steps with a
    checkpoint, then a resume of RESUME_STEPS more, which must start from
    the saved weights (its first loss far below the first run's first); the
    launch counters are reset before this phase and must grow by exactly
    one step's launches per step.  Returns the launches of the phase, and
    each kernel's launches per step in the first run of its domain."""
    from spectralae_torch.io import checkpoint as ckpt
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import spectral_kernels as sk
    common = ["train", "--nx", "256", "--layers", "3", "--batch", "8",
              "--seed", "0", "--log-every", "1"]
    sk.LAUNCHES = 0
    ck.LAUNCHES = 0
    per_step_seen = {}
    for domain in ("fft", "coord"):
        per_step = ((K1_PER_FFT_STEP, 0) if domain == "fft"
                    else (0, K2_PER_COORD_STEP))
        ck_dir = tmp / f"train_{domain}"
        argv = common + ["--domain", domain, "--ckpt", str(ck_dir),
                         "--ckpt-every", "10"]
        for steps, extra in ((TRAIN_STEPS, []),
                             (TRAIN_STEPS + RESUME_STEPS,
                              ["--resume", str(ck_dir)])):
            before = (sk.LAUNCHES, ck.LAUNCHES)
            t0 = time.perf_counter()
            recs = _cli_records(argv + ["--steps", str(steps)] + extra)
            wall = time.perf_counter() - t0
            grew = (sk.LAUNCHES - before[0], ck.LAUNCHES - before[1])
            losses = [r["loss"] for r in recs]
            first = 0 if not extra else TRAIN_STEPS
            check([r["step"] for r in recs] == list(range(first, steps)),
                  f"train {domain}: logged steps {[r['step'] for r in recs]}")
            check(all(math.isfinite(v) for v in losses),
                  f"train {domain}: non-finite loss {losses}")
            n = steps - first
            check(grew == (per_step[0] * n, per_step[1] * n),
                  f"train {domain}: {n} steps launched K1 {grew[0]}x and K2 "
                  f"{grew[1]}x, expected {per_step[0] * n} and "
                  f"{per_step[1] * n}")
            _, _, opt, extra_ck = ckpt.load(ck_dir)
            check(extra_ck["step"] == steps and opt is not None,
                  f"train {domain}: checkpoint at step {extra_ck['step']}")
            print(f"train {domain} 256x256 b8 steps {first}-{steps - 1}"
                  f"{' (resumed)' if extra else ''}: loss {losses[0]:.6g} "
                  f"-> {losses[-1]:.6g}; launches K1 +{grew[0]} K2 "
                  f"+{grew[1]} ({per_step[0] or per_step[1]} per step); "
                  f"{wall:.2f} s wall", flush=True)
            if not extra:
                check(losses[-1] < losses[0],
                      f"train {domain}: the loss did not fall: {losses}")
                loss0 = losses[0]
                kern, i = ("k1", 0) if domain == "fft" else ("k2", 1)
                per_step_seen[kern] = grew[i] / n
            else:
                check(losses[0] < 0.1 * loss0,
                      f"train {domain}: the resumed run's first loss "
                      f"{losses[0]:.6g} is not far below the first run's "
                      f"{loss0:.6g}; it did not start from the checkpoint")
    return (sk.LAUNCHES, ck.LAUNCHES), per_step_seen


def phase_train_vs_cpu(tmp: Path) -> None:
    """The same 3-step run (weights and frames from one seed) on the card
    and on the CPU, where the plain versions run: parameters, momentum and
    the last raw gradient, each held on its own (most gradients are above
    GRAD_CLIP, where the update sees only their sign)."""
    from spectralae_torch.io import checkpoint as ckpt
    for domain, tol in (("fft", TOL_FFT), ("coord", TOL_COORD)):
        got = {}
        for device in ("cuda", "cpu"):
            dest = tmp / f"three_{domain}_{device}"
            _cli_records(["train", "--nx", "256", "--layers", "3",
                          "--batch", "8", "--steps", "3", "--seed", "0",
                          "--domain", domain, "--device", device,
                          "--ckpt", str(dest)])
            params, _, opt, _ = ckpt.load(dest)
            got[device] = [torch.cat([t.reshape(-1) for t in tree.leaves()])
                           for tree in (params, opt.mom, opt.prev_grad)]
        for name, a, b, t in zip(("parameters", "momentum", "raw gradient"),
                                 got["cuda"], got["cpu"],
                                 (tol, TOL_MOM, tol)):
            err = rel_err(a, b)
            print(f"train {domain} 3 steps, card vs CPU port: {name} rel "
                  f"{err:.3e} (tol {t:g})", flush=True)
            check(err <= t, f"train {domain}: card and CPU disagree in "
                  f"{name}: {err:.3e} > {t:g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from spectralae_torch import _kernels

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    build = _kernels.build()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", build.log)]
    spills = sum(int(s) for s in
                 re.findall(r"(\d+) bytes spill stores", build.log))
    print(f"built {build.path.name} in {build.seconds:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s); ptxas: "
          f"{len(regs)} kernels, at most {max(regs, default=0)} registers, "
          f"{spills} bytes of spill stores", flush=True)

    # 3. kernels against their plain versions; forwards and train steps
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed, errs = phase_kernels(gen)
    phase_forward()
    step = per_step(timed, phase_train_step())

    # 4. the serving path; 5. the training path
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        served = phase_serving(tmp)
        trained, per_step_seen = phase_training(tmp)
        phase_train_vs_cpu(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(min(served) > 0 and min(trained) > 0,
          f"launches: serving K1 {served[0]} K2 {served[1]}, training K1 "
          f"{trained[0]} K2 {trained[1]}")

    kernels = []
    for i, (key, name, source, replaces) in enumerate((
            ("k1", "cmul_contract", "spectralae_torch/csrc/cmul_contract.cu",
             "spectralae/ops/pallas_kernels.py:48"),
            ("k2", "conv_valid", "spectralae_torch/csrc/conv_valid.cu",
             "spectralae/ops/pallas_conv.py:110"))):
        s = step[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": served[i] + trained[i],
            "launches_by_path": {"serve": served[i], "train": trained[i]},
            "max_abs_err": errs[key], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "per": "one 256x256 batch-8 train step of the 3-pair net",
            "launches_per_step": per_step_seen[key],
            "fwd_ms": s["fwd_ms"], "fwd_plain_ms": s["fwd_plain_ms"],
            "bwd_ms": s["bwd_ms"], "bwd_plain_ms": s["bwd_plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
