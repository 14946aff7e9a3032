"""The benchmark's analytic counts: operations and bytes from shapes alone.

Frozen copies of the program's cost arithmetic, so that a later change to
the program cannot move the yardstick:

- ``HBM_BYTES_PER_S``, ``FP32_FLOP_PER_S``, :func:`bound_ms`,
  :func:`k1_bound`, :func:`k2_bound`: ``chip_smoke.py:273-274, 507-529``;
- :func:`fft_flops`: ``spectralae_torch/core/roofline.py:111-128`` (the
  FFTW convention), on shapes instead of an aten call's tensors;
- :func:`spectral_conv_bytes`, :func:`fft_step_bytes`:
  ``spectralae_torch/core/roofline.py:405-441``.

On top of them, the step of the mirrored autoencoder by domain: its stages'
shapes (:func:`stages`), the work the algorithm needs (:func:`step_flops`)
and the least time of its spectral contractions and of its valid
correlations on the card (:func:`spectral_conv_bound_ms`,
:func:`coord_conv_bound_ms`).  The counts take what the algorithm needs,
whichever kernel runs it: each operand read once, each result written once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

# NVIDIA's H100 SXM data sheet: HBM3 bandwidth, and the float32 rate
# outside the tensor cores (the port runs float32 with TF32 off)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(a: int, k: int, b: int, w: int, bias: bool = False,
             op_bytes: int = 8):
    """[A,K,W] x [K,B,W] -> [A,B,W] complex64: each operand read once
    (``op_bytes`` a complex element: 8, or 4 for bf16 operands), the output
    written once; 8 flops per complex multiply-add."""
    return bound_ms(8.0 * a * k * b * w,
                    op_bytes * w * (a * k + k * b) + 8.0 * w * a * b
                    + (4 * b if bias else 0))


def k2_bound(b: int, d: int, m: int, hp: int, wp: int, nk: int, nl: int):
    """Valid correlation [B,D,Hp,Wp] x [M,D,nk,nl] -> [B,M,H,W] float32."""
    h, wo = hp - nk + 1, wp - nl + 1
    return bound_ms(2.0 * b * m * d * nk * nl * h * wo,
                    4.0 * (b * d * hp * wp + m * d * nk * nl + b * m * h * wo))


def wgrad_bound(b: int, d: int, m: int, hp: int, wp: int, nk: int, nl: int):
    """The weight gradient of :func:`k2_bound`'s correlation: [B,D,Hp,Wp]
    against [B,M,H,W] -> [M,D,nk,nl] float32; the same multiply-adds, each
    operand read once and the taps written once."""
    h, wo = hp - nk + 1, wp - nl + 1
    return bound_ms(2.0 * b * m * d * nk * nl * h * wo,
                    4.0 * (b * d * hp * wp + b * m * h * wo + m * d * nk * nl))


def fft_flops(shape, dims, *, complex_input: bool = False) -> float:
    """Flops of one FFT over ``dims`` of an array of ``shape`` (the real
    side's shape for a real transform): 5·n·log2 n for each complex
    transform of n points, 2.5·n·log2 n for each real one, times the
    transforms in the batch."""
    n = 1
    for d in dims:
        n *= shape[d]
    if n <= 1:
        return 0.0
    per = (5.0 if complex_input else 2.5) * n * math.log2(n)
    return per * (math.prod(shape) // n)


def spectral_conv_bytes(B: int, D: int, M: int, nx: int, ny: int) -> float:
    """Analytic HBM byte bound for one rfft2 → pointwise conv → irfft2
    round trip: every resolution-sized array counted once written + once
    read where it crosses an operation boundary (input read, X/kernel/Y
    spectra w+r as split-complex f32, output write)."""
    nyr = ny // 2 + 1
    cplx = 8.0
    return float(B * D * nx * ny * 4            # x read
                 + 2 * B * D * nx * nyr * cplx  # X write+read
                 + 2 * M * D * nx * nyr * cplx  # kernel spectra w+r
                 + 2 * B * M * nx * nyr * cplx  # Y write+read
                 + B * M * nx * ny * 4)         # out write


def fft_step_bytes(B: int, D: int, M: int, nx: int, ny: int,
                   pairs: int) -> float:
    """Analytic HBM byte bound for one fwd+bwd train step: forward traffic
    = the input/output planes plus each stage's activation spectra
    (write+read, split-complex) down the pooled pyramid and back up;
    backward ≈ 2× forward.  A bound, not an exact count."""
    def nyr_of(r):
        return r // 2 + 1
    fwd = B * D * nx * ny * 4.0 + B * D * nx * ny * 4.0   # x read, recon w
    for s in range(pairs):
        r = nx >> (s + 1)                # resolution after encoder pool s
        din = D if s == 0 else M
        stage = (B * din * r * nyr_of(r) * 8.0
                 + B * M * r * nyr_of(r) * 8.0)
        fwd += 2 * stage
    return float(3.0 * fwd)


class Stage(NamedTuple):
    """One conv stage of the mirrored net: ``d`` → ``m`` channels on an
    ``nx`` × ``ny`` grid, with ``nk`` × ``nl`` taps; ``first`` when its input
    is the frames' (no gradient flows into it)."""
    m: int
    d: int
    nx: int
    ny: int
    nk: int
    nl: int
    first: bool


def stages(cfg: dict, nx: int, ny: int) -> list[Stage]:
    """The stages of ``cfg``'s net on ``nx`` × ``ny`` frames: ``pairs``
    encoder stages (pool by ``scale``, then conv ``d`` → ``depth``), then
    their mirrors (conv, then unpool).  The net the reference grows with
    its 'n' key (autoencoder.cpp:384-431)."""
    nk, nl, s = cfg["nk"], cfg["nl"], cfg["scale"]
    enc, gx, gy, d = [], nx, ny, cfg["d"]
    for i in range(cfg["pairs"]):
        gx, gy = gx // s, gy // s
        enc.append(Stage(cfg["depth"], d, gx, gy, nk, nl, i == 0))
        d = cfg["depth"]
    dec = [Stage(st.d, st.m, st.nx, st.ny, nk, nl, False)
           for st in reversed(enc)]
    return enc + dec


def _bins(st: Stage) -> int:
    return st.nx * (st.ny // 2 + 1)


def step_flops(cfg: dict, domain: str, batch: int, nx: int,
               ny: int) -> float:
    """The operations one train step needs.

    ``fft``: the frames' rfft2, the reconstruction's irfft2 and its
    gradient's transform (2.5·N·log2 N a real 2-D transform), and the
    spectral contractions at 8 flops a complex multiply-add: each stage's
    forward product and its weight gradient, and the data gradient of every
    stage but the first.  The kernels' spectra (a 5 × 5 support's restricted
    DFT) are left out.  ``coord``: the valid correlations at 2 flops a
    multiply-add, forward, data gradient (not the first stage's) and weight
    gradient."""
    total = 0.0
    if domain == "fft":
        total += 3 * fft_flops((batch, cfg["d"], nx, ny), (2, 3))
        for st in stages(cfg, nx, ny):
            products = 2 if st.first else 3
            total += products * 8.0 * batch * st.m * st.d * _bins(st)
        return total
    if domain == "coord":
        for st in stages(cfg, nx, ny):
            products = 2 if st.first else 3
            total += (products * 2.0 * batch * st.m * st.d * st.nk * st.nl
                      * st.nx * st.ny)
        return total
    raise ValueError(f"unknown domain {domain!r}")


def spectral_conv_bound_ms(cfg: dict, batch: int, nx: int, ny: int) -> float:
    """The least time of one step's spectral contractions (complex64):
    per stage the forward ``[B,D] x [D,M]`` with the DC bias, the weight
    gradient ``[M,B] x [B,D]`` and, past the first stage, the data gradient
    ``[B,M] x [M,D]``, each at every bin."""
    total = 0.0
    for st in stages(cfg, nx, ny):
        w = _bins(st)
        total += k1_bound(batch, st.d, st.m, w, bias=True)[0]
        total += k1_bound(st.m, batch, st.d, w)[0]
        if not st.first:
            total += k1_bound(batch, st.m, st.d, w)[0]
    return total


def coord_conv_bound_ms(cfg: dict, batch: int, nx: int, ny: int) -> float:
    """The least time of one step's valid correlations (float32, on inputs
    padded by the taps' half-widths): per stage the forward, the weight
    gradient and, past the first stage, the data gradient."""
    total = 0.0
    for st in stages(cfg, nx, ny):
        hp, wp = st.nx + st.nk - 1, st.ny + st.nl - 1
        total += k2_bound(batch, st.d, st.m, hp, wp, st.nk, st.nl)[0]
        total += wgrad_bound(batch, st.d, st.m, hp, wp, st.nk, st.nl)[0]
        if not st.first:
            total += k2_bound(batch, st.m, st.d, hp, wp, st.nk, st.nl)[0]
    return total
