"""Hand-written CUDA kernels for the radix-4 four-step rfft2 (B5).

Counterpart of :mod:`spectralae.ops.pallas_fft`.  The stream trainer's
fused precompute (``pallas_windows="fft"|"fft-bf16"``) takes the signal
half-spectra from these kernels instead of cuFFT, in the kernels' own
"mixed" bin order, and gathers them to natural order for the anchor kernel
K4 (:func:`gather_natural`).

Factorization (both axes, fixed split radix 4, decimation in frequency)::

    n = 4·M1,   j = j2·M1 + j1   (j2 ∈ [0,4) selects a contiguous block)
    ω = 4·k1 + k2

    X[4k1+k2] = Σ_{j1} W_{M1}^{j1 k1} · W_n^{j1 k2} · S[k2][j1]
    S[k2]     = Σ_{j2} W_4^{j2 k2} · x[j2·M1 + j1]     (radix-4 butterfly)

ω = 4·k1 + k2 lands at block k2, position k1: :func:`perm_x` and
:func:`perm_y` give the bin of every mixed row and lane;
:func:`gather_natural` and :func:`rfft2_pallas` bring the output to
natural order.  The y-stage
emits ω_y ≤ ny/2 only (k1 < k1p columns per block).  An axis longer than
``4·_MAX_M1`` peels wrapper-level butterfly rounds until the leaf fits
(ω = k2 + 4·ω′ per round).

Three kernels in ``csrc/rfft2_mixed.cu`` carry the five Pallas bodies: the
leaf contraction (real and complex y-leaf, the x-leaf) and one butterfly
round along lanes or rows.  Each has a plain PyTorch version here
(:func:`rfft_y_mixed_plain`, :func:`_fft_yc_plain`,
:func:`fft_x_mixed_plain`, :func:`_bfly_lanes_plain`,
:func:`_bfly_rows_plain`): the same butterfly, twiddle and matmul against
the same bases, so even the lanes past Nyquist that some radix blocks carry
hold the kernel's values.  The wrappers run the plain version for CPU
tensors; for CUDA tensors they launch the kernel or raise.

``precision`` is the JAX dot tier and says which bf16 operand pieces feed
the leaves' tensor-core products on the card (``csrc/wgmma.cuh``):
``"default"`` (and None, as in JAX) one bf16 product, ``"high"`` the
bf16×3 split of ``_dot_fn`` (spectralae/ops/pallas_fft.py:151), ``"highest"``
bf16×6.  The operand is P, the twiddled butterfly, never the input: the
butterfly and twiddle stay exact float32, as in JAX.  The plain versions
take the same ``precision`` and round the same operands
(:func:`split_dot`); on CPU tensors the wrappers compute float32 products
for every tier, as JAX's own ``jnp.dot`` does on the CPU.  TF32 is never
used.  ``out_dtype=torch.bfloat16`` rounds the stored planes, as the JAX
kernel's store does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels
from . import dft

_LANE = 128

# largest leaf contraction length n/4; longer axes peel butterfly rounds
# (one extra pass over the planes each).  The tests shrink it to force the
# recursion at small sizes.
_MAX_M1 = 512

_PRECISIONS = (None, "default", "high", "highest")
#: the JAX dot tiers the matmul-DFT kernels run at on the card
TIERS = ("default", "high", "highest")
#: the C kernels' tier numbers (csrc/wgmma.cuh)
_TIERS = {"default": 0, "high": 1, "highest": 2}
#: (a piece, b piece) of each product of a tier, the small terms first, as
#: csrc/wgmma.cuh orders them ("high": JAX's lo·hi + hi·lo + hi·hi)
_PRODUCTS = {"default": ((0, 0),),
             "high": ((1, 0), (0, 1), (0, 0)),
             "highest": ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))}
#: the tensor cores' dense bf16 rate (NVIDIA's H100 SXM data sheet): with
#: a tier's products, what a matmul DFT costs on them, a figure of a
#: design and not a bound of its function (:func:`design_tc_ms`)
BF16_TC_FLOP_PER_S = 989e12

# The tiers' bounds, for every check of the two matmul-DFT kernels (the
# leaves here, P2 in probe_kernels) and their plain versions.
#: a tier against the exact transform (norm-relative): "highest" (bf16×6)
#: and "high" (bf16×3) the JAX tests' 2e-6 and 1e-5
#: (tests/test_pallas_fft.py:25-44); "default" rounds both operands to
#: bf16, each by up to 2^-8, ~3e-3 rms a product: 2.3e-3 on pixel frames
#: and 2.8e-3 on noise through the plain tier versions, so 6e-3 (the JAX
#: docstring's ~2e-4, pallas_fft.py:42-45, does not hold for this norm)
TIER_TOL = {"default": 6e-3, "high": 1e-5, "highest": 2e-6}
#: P2's energy against the rfft route (relative): "default" rounds x and
#: the bases to bf16 and the energy's error averages over its terms, 8e-4
#: at the JAX probe's check case [3, 32, 48] and less above it, so 1e-3
#: from there up; the others within the transform's bounds
P2_TIER_TOL = {"default": 1e-3, "high": 1e-5, "highest": 2e-6}
#: ... and below the check case's 4,608 values "default" rounds fewer
#: terms: 1.8e-3 at [1, 64, 7], so the operands' 2^-8
P2_SMALL, P2_SMALL_DEFAULT_TOL = 3 * 32 * 48, 2 ** -8

#: the kernels' tiles, in which the host lays out the bases' pieces and
#: which each launch passes for its kernel to check: the leaf's
#: frequencies a block and j a chunk (csrc/rfft2_mixed.cu kTF, kJC), the
#: sweep's bins a block and y a chunk (csrc/probes.cu kPB, kPY)
LEAF_TILE = (32, 32)
SWEEP_TILE = (64, 64)


def design_tc_ms(flops: float, precision: str) -> float:
    """Milliseconds of ``flops`` of products at the bf16 tensor-core peak,
    times ``precision``'s products a pair of operands."""
    return flops * len(_PRODUCTS[precision]) / BF16_TC_FLOP_PER_S * 1e3


def p2_tier_tol(precision: str, numel: int) -> float:
    """P2's bound against the rfft route at ``precision`` for an input of
    ``numel`` values (:data:`P2_TIER_TOL`, :data:`P2_SMALL_DEFAULT_TOL`)."""
    if precision == "default" and numel < P2_SMALL:
        return P2_SMALL_DEFAULT_TOL
    return P2_TIER_TOL[precision]


def _k1p(ny: int) -> int:
    """Padded per-block k1 width of the y-stage: K1 = ny//8 + 1 columns
    (ω = 4·k1 ≤ ny/2 incl. Nyquist), padded to a lane-friendly width."""
    k1 = ny // 8 + 1
    pad = _LANE // 4 if ny % (2 * _LANE) == 0 else 8
    return -(-k1 // pad) * pad


def ny_padded(ny: int) -> int:
    """Total mixed-order lane count of the rfft2 output (≥ ny//2+1)."""
    return len(perm_y(ny))


def perm_y(ny: int) -> np.ndarray:
    """ωy of each mixed-order lane; −1 marks a lane that holds no needed
    bin (give it zero weight and basis downstream).  Recursive over the
    wrapper's butterfly rounds: a peeled round contributes the least
    significant base-4 digit, ω = k2 + 4·ω′."""
    if ny // 4 > _MAX_M1:
        sub = perm_y(ny // 4)
        parts = []
        for k2 in range(4):
            w = np.where(sub >= 0, k2 + 4 * sub, -1)
            parts.append(np.where((w >= 0) & (w <= ny // 2), w, -1))
        return np.concatenate(parts)
    k1p = _k1p(ny)
    out = np.full(4 * k1p, -1, np.int64)
    for k2 in range(4):
        for k1 in range(k1p):
            w = 4 * k1 + k2
            if w <= ny // 2:
                out[k2 * k1p + k1] = w
    return out


def perm_x(nx: int) -> np.ndarray:
    """ωx of each mixed-order row: row k2·M1 + k1 holds ωx = 4·k1 + k2
    (recursively, ω = k2 + 4·ω′ per peeled butterfly round)."""
    if nx // 4 > _MAX_M1:
        sub = perm_x(nx // 4)
        return np.concatenate([k2 + 4 * sub for k2 in range(4)])
    m1 = nx // 4
    return np.concatenate([4 * np.arange(m1) + k2 for k2 in range(4)])


@functools.lru_cache(maxsize=None)
def _y_bases_np(ny: int):
    """y-leaf bases ``bc, bs [m1, k1p]`` and twiddles ``twc, tws [4, m1]``."""
    m1 = ny // 4
    k1p = _k1p(ny)
    j1 = np.arange(m1)[:, None]
    k1 = np.arange(k1p)[None, :]
    th = 2 * np.pi * (j1 * k1) / m1
    # columns that are padding for EVERY k2 (4·k1 > ny/2 already at k2=0)
    # emit exact zeros; columns valid for some-but-not-all k2 emit
    # beyond-Nyquist bins there — perm_y marks them −1
    dead = 4 * k1 > ny // 2
    bc = np.where(dead, 0.0, np.cos(th)).astype(np.float32)
    bs = np.where(dead, 0.0, np.sin(th)).astype(np.float32)
    a = 2 * np.pi * np.arange(4)[:, None] * np.arange(m1)[None, :] / ny
    return bc, bs, np.cos(a).astype(np.float32), np.sin(a).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _x_bases_np(nx: int):
    """x-leaf bases ``bc, bs [k1, j1]`` (symmetric) and twiddles
    ``twc, tws [4, m1, 1]``."""
    m1 = nx // 4
    th = 2 * np.pi * np.outer(np.arange(m1), np.arange(m1)) / m1  # [k1,j1]
    a = 2 * np.pi * np.arange(4)[:, None] * np.arange(m1)[None, :] / nx
    return (np.cos(th).astype(np.float32), np.sin(th).astype(np.float32),
            np.cos(a).astype(np.float32)[:, :, None],
            np.sin(a).astype(np.float32)[:, :, None])


@functools.lru_cache(maxsize=None)
def _bfly_tw_np(n: int):
    """Butterfly round twiddles W_n^{j·k2}, j < n/4: (cos, sin) [4, m]."""
    m = n // 4
    a = 2 * np.pi * np.arange(4)[:, None] * np.arange(m)[None, :] / n
    return np.cos(a).astype(np.float32), np.sin(a).astype(np.float32)


def natural_gathers(nx: int, ny: int):
    """(row_of [nx], lane_of [nyr]) index maps from natural (ωx, ωy) to
    mixed-order positions — ``X_nat = X_mixed[row_of][:, lane_of]``."""
    py = perm_y(ny)
    lane_of = np.zeros(ny // 2 + 1, np.int64)
    lane_of[py[py >= 0]] = np.nonzero(py >= 0)[0]
    row_of = np.zeros(nx, np.int64)
    row_of[perm_x(nx)] = np.arange(nx)
    return row_of, lane_of


# ------------------------------------------------------- plain versions

def _bfly_twiddle(qr, qi, twc, tws):
    """One DIF radix-4 round on the four quarters ``qr``/``qi`` (``qi``
    None: real input): the butterfly, then the twiddle ``W_n^{j·k2}``
    (``twc[k2]``, ``tws[k2]`` shaped to broadcast).  Returns the four
    twiddled streams as (re, im) pairs, k2 order."""
    if qi is None:
        # real input: S0 and S2 are real, S3 = conj(S1)
        e, o = qr[0] + qr[2], qr[1] + qr[3]
        dr, di = qr[0] - qr[2], qr[3] - qr[1]
        z = torch.zeros_like(e)
        S = [(e + o, z), (dr, di), (e - o, z), (dr, -di)]
    else:
        e_r, e_i = qr[0] + qr[2], qi[0] + qi[2]
        o_r, o_i = qr[1] + qr[3], qi[1] + qi[3]
        d_r, d_i = qr[0] - qr[2], qi[0] - qi[2]
        f_r, f_i = qr[1] - qr[3], qi[1] - qi[3]
        S = [(e_r + o_r, e_i + o_i), (d_r + f_i, d_i - f_r),
             (e_r - o_r, e_i - o_i), (d_r - f_i, d_i + f_r)]
    return [(sr * twc[k] + si * tws[k], si * twc[k] - sr * tws[k])
            for k, (sr, si) in enumerate(S)]


_BASES = {"y": _y_bases_np, "x": _x_bases_np, "bfly": _bfly_tw_np}


def tier(precision) -> str:
    """The tier a ``precision`` runs at on the card: None is ``"default"``
    (spectralae/ops/pallas_fft.py:471-472)."""
    _check_precision(precision)
    return "default" if precision is None else precision


def pieces(a: torch.Tensor, n: int) -> list[torch.Tensor]:
    """The first ``n`` bf16 pieces of float32 ``a`` (held as float32):
    ``p0 = bf16(a)``, ``p1 = bf16(a − p0)``, ``p2 = bf16(a − p0 − p1)``;
    each residual is exact in float32, as in the kernels' split."""
    out = []
    for _ in range(n):
        p = a.to(torch.bfloat16).float()
        out.append(p)
        a = a - p
    return out


def split_dot(a: torch.Tensor, b: torch.Tensor, precision) -> torch.Tensor:
    """``a @ b`` as the tensor cores take it at ``precision``: the sum of
    the tier's products of bf16 pieces (:data:`_PRODUCTS`), each exact in
    float32, summed in float32.  ``precision=None``: the float32 product
    (the CPU route)."""
    if precision is None:
        return a @ b
    n = _TIERS[precision] + 1
    pa, pb = pieces(a, n), pieces(b, n)
    out = None
    for i, j in _PRODUCTS[precision]:
        t = pa[i] @ pb[j]
        out = t if out is None else out + t
    return out


def core_order(t: torch.Tensor) -> torch.Tensor:
    """``[..., R, 64]`` tiles (R a multiple of 8) flattened in the kernels'
    shared-memory order: 8×8 core matrices, row groups outer
    (``csrc/wgmma.cuh`` ``tile_off``)."""
    *lead, r, k = t.shape
    return (t.reshape(*lead, r // 8, 8, k // 8, 8).transpose(-3, -2)
            .reshape(*lead, r * k))


def tile_pieces(b: torch.Tensor, precision: str) -> torch.Tensor:
    """``[..., R, 64]`` float32 tiles as ``precision``'s bf16 pieces in
    core-matrix order, the pieces on a new axis before the last:
    ``[..., pieces, R·64]`` bf16."""
    with torch.inference_mode(False):
        return torch.stack([core_order(p.to(torch.bfloat16)) for p in
                            pieces(b, _TIERS[precision] + 1)], -2)


@functools.lru_cache(maxsize=None)
def _bases_on(kind: str, n: int, device: torch.device):
    """A kernel's bases and twiddles (``y``: :func:`_y_bases_np`, ``x``:
    :func:`_x_bases_np`, ``bfly``: :func:`_bfly_tw_np`) as float32 tensors
    kept on ``device``."""
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, device=device)
                     for a in _BASES[kind](n))


def _bfly_lanes_plain(xr, xi, n: int):
    """Plain version of the lane round: ``[BD, R, n]`` (real when ``xi`` is
    None) → twiddled streams ``(re, im) [BD, 4, R, n/4]`` float32."""
    m = n // 4
    twc, tws = _bases_on("bfly", n, xr.device)
    qr = xr.unflatten(-1, (4, m)).unbind(-2)
    qi = None if xi is None else xi.unflatten(-1, (4, m)).unbind(-2)
    S = _bfly_twiddle(qr, qi, twc, tws)
    return (torch.stack([s[0] for s in S], dim=1),
            torch.stack([s[1] for s in S], dim=1))


def _bfly_rows_plain(yr, yi, n: int):
    """Plain version of the row round: ``[BD, n, L]`` complex →
    ``(re, im) [BD, 4, n/4, L]``."""
    m = n // 4
    twc, tws = _bases_on("bfly", n, yr.device)
    qr = yr.unflatten(1, (4, m)).unbind(1)
    qi = yi.unflatten(1, (4, m)).unbind(1)
    S = _bfly_twiddle(qr, qi, twc[:, :, None], tws[:, :, None])
    return (torch.stack([s[0] for s in S], dim=1),
            torch.stack([s[1] for s in S], dim=1))


@dft.ieee_f32()
def _y_contract(pr, pi, n: int, precision):
    """The y-leaf's matmul DFT of the twiddled streams ``[..., m1]``
    against the bases ``[m1, k1p]`` (``X = P·(bc − i·bs)``), its operands
    rounded to ``precision``'s pieces (:func:`split_dot`)."""
    bc, bs = _bases_on("y", n, pr.device)[:2]

    def dot(a, b):
        return split_dot(a, b, precision)
    return dot(pr, bc) + dot(pi, bs), dot(pi, bc) - dot(pr, bs)


def rfft_y_mixed_plain(x: torch.Tensor, precision=None):
    """Plain version of the real y-leaf: ``x [BD, R, n]`` float32 →
    ``(Yre, Yim) [BD, 4, R, k1p]``.  ``precision``: None for float32
    products (the CPU route), or the tier whose bf16 pieces of P and the
    bases the kernel multiplies on the card."""
    return _y_contract(*_bfly_lanes_plain(x, None, x.shape[-1]), x.shape[-1],
                       precision)


def _fft_yc_plain(yr: torch.Tensor, yi: torch.Tensor, precision=None):
    """Plain version of the complex y-leaf: ``[BD, R, n]`` →
    ``(re, im) [BD, 4, R, k1p]`` (ω ≤ n/2); ``precision`` as for
    :func:`rfft_y_mixed_plain`."""
    return _y_contract(*_bfly_lanes_plain(yr, yi, yr.shape[-1]),
                       yr.shape[-1], precision)


@dft.ieee_f32()
def fft_x_mixed_plain(yr: torch.Tensor, yi: torch.Tensor, out_dtype=None,
                      precision=None):
    """Plain version of the x-leaf: ``[BD, nx, L]`` complex →
    ``(Xre, Xim) [BD, nx, L]`` in mixed row order, stored as
    ``out_dtype`` (float32 by default); ``precision`` as for
    :func:`rfft_y_mixed_plain`."""
    BD, nx, L = yr.shape
    pr, pi = _bfly_rows_plain(yr, yi, nx)                 # [BD, 4, m1, L]
    bc, bs = _bases_on("x", nx, yr.device)[:2]          # [k1, j1]

    def dot(a, b):
        return split_dot(a, b, precision)
    out = torch.float32 if out_dtype is None else out_dtype
    re = (dot(bc, pr) + dot(bs, pi)).reshape(BD, nx, L)
    im = (dot(bc, pi) - dot(bs, pr)).reshape(BD, nx, L)
    return re.to(out), im.to(out)


def rfft2_mixed_plain(x: torch.Tensor, *, precision=None, out_dtype=None,
                      y_planes=None):
    """:func:`rfft2_mixed` through the plain versions alone, on any device:
    the same butterfly rounds and leaves, the leaves' operands rounded to
    ``precision``'s pieces (None: float32 products).  On the card it is
    what the kernels compute at that tier, summed in another order.
    ``y_planes``: the y-stage's ``(Yre, Yim) [..., G, nx, k1p]``
    (:func:`rfft_y_mixed`) to take the x-stage from, in place of the plain
    y-stage: with the kernels' own, the x-stage is held to its plain
    version alone, since at ``"default"`` the x-leaf rounds to bf16 a
    y-stage output that kernel and plain sum in other orders."""
    nx, ny = x.shape[-2], x.shape[-1]
    lead = tuple(x.shape[:-2])

    def y_axis(xr, xi, n):                # [BD, R, n] -> [BD, G, R, k1p]
        if n // 4 <= _MAX_M1:
            return (rfft_y_mixed_plain(xr, precision) if xi is None
                    else _fft_yc_plain(xr, xi, precision))
        BD, R = xr.shape[:2]
        br, bi = _bfly_lanes_plain(xr, xi, n)
        sr, si = y_axis(br.reshape(-1, R, n // 4), bi.reshape(-1, R, n // 4),
                        n // 4)
        return tuple(a.reshape(BD, -1, R, a.shape[-1]) for a in (sr, si))

    def x_axis(yr, yi, n):                # [BD, n, L] -> [BD, n, L]
        if n // 4 <= _MAX_M1:
            return fft_x_mixed_plain(yr, yi, out_dtype, precision)
        br, bi = _bfly_rows_plain(yr, yi, n)
        sr, si = x_axis(br.reshape(-1, n // 4, yr.shape[-1]),
                        bi.reshape(-1, n // 4, yr.shape[-1]), n // 4)
        return sr.reshape(yr.shape), si.reshape(yr.shape)

    if y_planes is None:
        yr, yi = y_axis(x.reshape(-1, nx, ny), None, ny)
    else:
        yr, yi = y_planes
    G, k1p = yr.shape[-3], yr.shape[-1]
    xr, xi = x_axis(yr.reshape(-1, nx, k1p), yi.reshape(-1, nx, k1p), nx)
    return tuple(a.reshape(lead + (G, nx, k1p)).movedim(-3, -2)
                 .reshape(lead + (nx, G * k1p)) for a in (xr, xi))


# ----------------------------------------------------------- wrappers

def _on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device
    raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")


@functools.lru_cache(maxsize=None)
def _consts_on(kind: str, n: int, device: torch.device) -> torch.Tensor:
    """A kernel's twiddles ``twc, tws [4, m]`` packed flat on ``device``,
    the layout its C entry point states."""
    with torch.inference_mode(False):
        return torch.cat([a.reshape(-1) for a in _bases_on(kind, n, device)
                          [-2:]])


@functools.lru_cache(maxsize=None)
def _leaf_tiles_on(kind: str, n: int, precision: str,
                   device: torch.device) -> torch.Tensor:
    """The leaf's bases as the kernel's B tiles: for frequency tile f (32
    frequencies) and j chunk c (32 j), the 64 × 64 matrix whose row n is
    the real part (n < 32) or the imaginary part of frequency 32f + n mod
    32 and whose column is Pr's (< 32) or Pi's j, ``[[bc, bs], [−bs, bc]]``
    (so ``[Pr | Pi]`` times it is ``P·(bc − i·bs)``), zero past m1 and K;
    split into ``precision``'s bf16 pieces in the kernels' core-matrix
    order: ``[nf, nc, pieces, 4096]`` bf16, built once on the host."""
    bc, bs = (torch.as_tensor(a) for a in _BASES[kind](n)[:2])   # [j, k]
    m1, K = bc.shape
    tf, jc = LEAF_TILE
    nf, nc = -(-K // tf), -(-m1 // jc)

    def tiled(a):
        z = torch.zeros(nc * jc, nf * tf)
        z[:m1, :K] = a
        return z.reshape(nc, jc, nf, tf).permute(2, 0, 3, 1)
    c, s = tiled(bc), tiled(bs)                       # [f, c, k, j]
    b = torch.cat([torch.cat([c, s], -1), torch.cat([-s, c], -1)], -2)
    return tile_pieces(b, precision).to(device)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


@_kernels.opaque
def _bfly_lanes(xr, xi, n: int):
    """One DIF radix-4 round along lanes (B5c): ``[BD, R, n] → [BD, 4, R,
    n/4]`` twiddled streams, float32 (``xi=None`` for real input)."""
    if not _on_card(xr, "_bfly_lanes"):
        return _bfly_lanes_plain(xr, xi, n)
    BD, R = xr.shape[0], xr.shape[1]
    xr = _f32(xr)
    xi = None if xi is None else _f32(xi)
    dev = xr.device
    outs = [torch.empty((BD, 4, R, n // 4), dtype=torch.float32, device=dev)
            for _ in range(2)]
    _kernels.launch("bfly_round_launch", "bfly_lanes", dev, xr.data_ptr(),
                    None if xi is None else xi.data_ptr(),
                    _consts_on("bfly", n, dev).data_ptr(), outs[0].data_ptr(),
                    outs[1].data_ptr(), BD, R, n, 1)
    return tuple(outs)


@_kernels.opaque
def _bfly_rows(yr, yi, n: int):
    """One DIF radix-4 round along rows (B5d): ``[BD, n, L] → [BD, 4, n/4,
    L]``."""
    if not _on_card(yr, "_bfly_rows"):
        return _bfly_rows_plain(yr, yi, n)
    BD, L = yr.shape[0], yr.shape[-1]
    yr, yi, dev = _f32(yr), _f32(yi), yr.device
    outs = [torch.empty((BD, 4, n // 4, L), dtype=torch.float32, device=dev)
            for _ in range(2)]
    _kernels.launch("bfly_round_launch", "bfly_rows", dev, yr.data_ptr(),
                    yi.data_ptr(), _consts_on("bfly", n, dev).data_ptr(),
                    outs[0].data_ptr(), outs[1].data_ptr(), BD, L, n, 0)
    return tuple(outs)


@_kernels.opaque
def _y_leaf(xr, xi, precision=None):
    """The y-leaf (B5a real, B5e complex): ``[BD, R, n] → [BD, 4, R,
    k1p]``; on the card at :func:`tier` ``(precision)``, on the CPU in
    float32."""
    key = "rfft_y_mixed" if xi is None else "fft_yc"
    if not _on_card(xr, key):
        return (rfft_y_mixed_plain(xr) if xi is None
                else _fft_yc_plain(xr, xi))
    BD, R, n = xr.shape
    k1p, t, dev = _k1p(n), tier(precision), xr.device
    xr = _f32(xr)
    xi = None if xi is None else _f32(xi)
    outs = [torch.empty((BD, 4, R, k1p), dtype=torch.float32, device=dev)
            for _ in range(2)]
    # the bases' tiles go before the outputs, the tier after the sizes
    _kernels.launch("rfft_y_leaf_launch", key, dev, xr.data_ptr(),
                    None if xi is None else xi.data_ptr(),
                    _consts_on("y", n, dev).data_ptr(),
                    _leaf_tiles_on("y", n, t, dev).data_ptr(),
                    outs[0].data_ptr(), outs[1].data_ptr(), BD, R, n, k1p,
                    _TIERS[t], *LEAF_TILE)
    return tuple(outs)


def _check_len(n: int, axis: str) -> None:
    if n % 4:
        raise ValueError(f"{axis} must be divisible by 4, got {n}")


def _check_precision(precision) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got "
                         f"{precision!r}")


def _fft_yc(yr, yi, *, precision=None):
    """Complex lane transform emitting ω ≤ n/2, group-leading:
    ``[BD, R, n] → [BD, G, R, k1p]`` with G = 4^rounds."""
    BD, R, n = yr.shape
    _check_len(n, "the lane length")
    if n // 4 > _MAX_M1:
        Br, Bi = _bfly_lanes(yr, yi, n)
        m = n // 4
        sr, si = _fft_yc(Br.reshape(-1, R, m), Bi.reshape(-1, R, m),
                         precision=precision)
        g, k1p = sr.shape[-3], sr.shape[-1]
        return (sr.reshape(BD, 4 * g, R, k1p), si.reshape(BD, 4 * g, R, k1p))
    return _y_leaf(yr, yi, precision)


def rfft_y_mixed(x: torch.Tensor, *, precision=None):
    """y-axis rfft of real ``x [..., nx, ny]`` float32 in mixed lane order.

    Returns ``(Yre, Yim) [..., G, nx, k1p]`` — group g, column k1 holds
    the ωy given by :func:`perm_y` at lane g·k1p + k1.  G = 4 when the leaf
    fits (ny ≤ 4·_MAX_M1); longer axes peel butterfly rounds (G =
    4^rounds).
    """
    _check_precision(precision)
    if x.dtype != torch.float32:
        raise TypeError(f"rfft_y_mixed takes float32, got {x.dtype}")
    nx, ny = x.shape[-2], x.shape[-1]
    _check_len(ny, "ny")
    lead = tuple(x.shape[:-2])
    xb = x.reshape(-1, nx, ny)
    if ny // 4 > _MAX_M1:
        Br, Bi = _bfly_lanes(xb, None, ny)
        m = ny // 4
        sr, si = _fft_yc(Br.reshape(-1, nx, m), Bi.reshape(-1, nx, m),
                         precision=precision)
        G = 4 * sr.shape[-3]
    else:
        sr, si = _y_leaf(xb, None, precision)
        G = 4
    k1p = sr.shape[-1]
    return (sr.reshape(lead + (G, nx, k1p)), si.reshape(lead + (G, nx, k1p)))


def fft_x_mixed(Yre: torch.Tensor, Yim: torch.Tensor, *, precision=None,
                out_dtype=None, lane_chunk=None):
    """x-axis FFT of complex ``(Yre, Yim) [..., nx, L]`` in mixed row
    order: output row k2·M1 + k1 holds ωx = 4·k1 + k2 (:func:`perm_x`).
    The lane axis is carried through untouched (any meaning or order).

    ``lane_chunk`` is the JAX kernel's lane tile; the result does not
    depend on it, and the CUDA kernel tiles lanes by its own width.
    """
    _check_precision(precision)
    if lane_chunk is not None and lane_chunk < 1:
        raise ValueError(f"lane_chunk must be positive, got {lane_chunk}")
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be None, float32 or bfloat16, not "
                        f"{out_dtype}")
    nx, L = Yre.shape[-2], Yre.shape[-1]
    _check_len(nx, "nx")
    lead = tuple(Yre.shape[:-2])
    yr = Yre.reshape(-1, nx, L)
    yi = Yim.reshape(-1, nx, L)
    if nx // 4 > _MAX_M1:
        # peel one butterfly round (ω = k2 + 4·ω′) and recurse; the four
        # twiddled streams ride the leading dim, so the recursive mixed
        # rows land k2-major — exactly perm_x's recursive order
        Br, Bi = _bfly_rows(yr, yi, nx)
        m = nx // 4
        sr, si = fft_x_mixed(Br.reshape(-1, m, L), Bi.reshape(-1, m, L),
                             precision=precision, out_dtype=out_dtype)
        return sr.reshape(lead + (nx, L)), si.reshape(lead + (nx, L))
    sr, si = _x_leaf(yr, yi, out_dtype, precision)
    return sr.reshape(lead + (nx, L)), si.reshape(lead + (nx, L))


@_kernels.opaque
def _x_leaf(yr, yi, out_dtype, precision):
    """The x-leaf (B5b): ``[BD, nx, L] → [BD, nx, L]`` in mixed row order,
    float32 or ``out_dtype``; on the card at :func:`tier` ``(precision)``,
    on the CPU in float32."""
    if not _on_card(yr, "fft_x_mixed"):
        return fft_x_mixed_plain(yr, yi, out_dtype)
    BD, nx, L = yr.shape
    out = torch.float32 if out_dtype is None else out_dtype
    yr, yi, dev, t = _f32(yr), _f32(yi), yr.device, tier(precision)
    outs = [torch.empty((BD, nx, L), dtype=out, device=dev) for _ in range(2)]
    _kernels.launch("fft_x_leaf_launch", "fft_x_mixed", dev, yr.data_ptr(),
                    yi.data_ptr(), _consts_on("x", nx, dev).data_ptr(),
                    _leaf_tiles_on("x", nx, t, dev).data_ptr(),
                    outs[0].data_ptr(), outs[1].data_ptr(), BD, nx, L,
                    int(out == torch.bfloat16), _TIERS[t], *LEAF_TILE)
    return tuple(outs)


def rfft2_mixed(x: torch.Tensor, *, precision=None, out_dtype=None,
                lead_chunk=None):
    """Two-stage rfft2 of real ``x [..., nx, ny]`` in mixed order.

    Returns ``(Xre, Xim) [..., nx, ny_padded(ny)]`` with row order
    :func:`perm_x` and lane order :func:`perm_y`; the DC bin sits at (row
    0, lane 0).  The y-group axis rides the x-stage as batch and is moved
    back into lanes at the end (one copy).  ``out_dtype=torch.bfloat16``
    rounds the stored planes.

    ``lead_chunk`` is accepted for the JAX signature and ignored: there it
    serializes the transform over the leading planes to fit a TPU's
    memory, with a bit-equal result.
    """
    nx, ny = x.shape[-2], x.shape[-1]
    lead = tuple(x.shape[:-2])
    Yre, Yim = rfft_y_mixed(x, precision=precision)
    G, k1p = Yre.shape[-3], Yre.shape[-1]
    Xre, Xim = fft_x_mixed(Yre.reshape(-1, nx, k1p),
                           Yim.reshape(-1, nx, k1p), precision=precision,
                           out_dtype=out_dtype)
    # [lead, G, nx, k1p] -> [lead, nx, G·k1p]
    return tuple(a.reshape(lead + (G, nx, k1p)).movedim(-3, -2)
                 .reshape(lead + (nx, G * k1p)) for a in (Xre, Xim))


@functools.lru_cache(maxsize=None)
def _natural_index(nx: int, ny: int, max_m1: int, device: torch.device):
    """:func:`natural_gathers` as one flat index into a ``[nx, lanes]``
    plane, on ``device`` (``max_m1``: the ``_MAX_M1`` that set the maps)."""
    row_of, lane_of = natural_gathers(nx, ny)
    flat = row_of[:, None] * ny_padded(ny) + lane_of[None, :]
    with torch.inference_mode(False):
        return torch.as_tensor(flat.ravel(), device=device)


def gather_natural(planes, nx: int, ny: int):
    """Mixed-order ``(Xre, Xim)`` planes ``[..., nx, ny_padded(ny)]``
    gathered to natural order ``[..., nx, ny//2+1]``, one index_select per
    plane; the dtype is kept."""
    idx = _natural_index(nx, ny, _MAX_M1, planes[0].device)
    return tuple(a.reshape(a.shape[:-2] + (-1,)).index_select(-1, idx)
                 .unflatten(-1, (nx, ny // 2 + 1)) for a in planes)


def to_natural(planes, nx: int, ny: int) -> torch.Tensor:
    """Mixed-order ``(Xre, Xim)`` planes (float32 or bf16) gathered to the
    natural-order complex64 half-spectra ``[..., nx, ny//2+1]``."""
    re, im = gather_natural(planes, nx, ny)
    return torch.complex(re.float(), im.float())


def rfft2_pallas(x: torch.Tensor, *, precision=None) -> torch.Tensor:
    """Natural-order complex64 rfft2 through the mixed-order kernels — the
    drop-in for ``torch.fft.rfft2(x)`` over the last two axes."""
    return to_natural(rfft2_mixed(x, precision=precision), x.shape[-2],
                      x.shape[-1])
