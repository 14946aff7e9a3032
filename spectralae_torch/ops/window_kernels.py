"""Hand-written CUDA kernels for the burst precompute's lag windows (K3, K4).

Counterpart of :mod:`spectralae.ops.pallas_windows`.  The correlation-space
burst (:mod:`spectralae_torch.train.fft_corr`) needs only centred lag
*windows* of the pairwise cross-correlations of a few half-spectra:

    W[d, e, u, v] = mean_b Σ_ω w(ω_y) · conj(X[b,d,ω]) · Z[b,e,ω]
                                     · cos/sin(2π(u ω_x/nx + v ω_y/ny))

(the separable restricted iDFT of :func:`spectralae_torch.ops.dft.lag_basis`
— the replacement for the reference's full-grid inverse FFTs around
``shrink_k``, source/fft_backproplib.cu:535-565, 1219-1226, of which the
burst only ever reads a (2h+1)² window).

- K3 :func:`corr_pair_windows` fuses the products and the window transform.
- K4 :func:`anchor_windows` is the whole fused-anchor precompute in one read
  of the signal spectra: the anchor spectra from the composed taps, the
  continuum error ``EG = s1·K̂₀X − X``, the XX and EG windows, ``Σw|EG|²``
  and the DC scalars.  Neither K̂₀ nor EG reaches device memory.  Its
  ``row_slab`` mode takes an x-row slab of the spectra and returns the
  slab's partial sums (the tensor-parallel precompute).

Both live in ``csrc/corr_windows.cu``, whose header note says what bounds
them and how they are laid out; :func:`window_plan` chooses their tiles
from the shape.  K4 also takes the four-step FFT's output
(:func:`spectralae_torch.ops.fft_kernels.rfft2_mixed`, ``mixed=True``),
gathered to natural bin order first.  Each has a plain PyTorch version here
(:func:`corr_pair_windows_plain`, :func:`anchor_windows_plain`), which the
wrappers run for CPU tensors; for CUDA tensors they launch the kernel or
raise.  Each kernel's C entry point runs its two grids (the rows, then the
sum over blocks).

Every product here runs in IEEE float32: the plain versions disable TF32
around their matmuls, the kernels never use tensor cores.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from . import dft, fft_kernels
from .spectral import _hermitian_weights

NUM_SMS, _GRID_YZ, _cdiv = _kernels.NUM_SMS, _kernels.GRID_YZ, _kernels.cdiv


def _combine_windows(sr: torch.Tensor, si: torch.Tensor, bxc: torch.Tensor,
                     bxs: torch.Tensor) -> torch.Tensor:
    """x-stage: fold the y-stage sums ``sr, si [planes, nx, vy]`` into the
    windows ``[planes, vx, vy]``."""
    return (torch.einsum("pxv,xu->puv", sr, bxc)
            - torch.einsum("pxv,xu->puv", si, bxs))


@functools.lru_cache(maxsize=None)
def _lag_bases_on(nx: int, ny: int, hx: int, hy: int, device: torch.device):
    """:func:`dft.lag_basis` as float32 tensors on ``device``, with the
    stacked y-stage basis ``[[byc bys], [−bys byc]]`` ``[2·nyr, 2·vy]``."""
    bxc, bxs, byc, bys = dft.lag_basis(nx, ny, hx, hy)
    ybasis = np.concatenate([np.concatenate([byc, bys], axis=1),
                             np.concatenate([-bys, byc], axis=1)], axis=0)
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, device=device)
                     for a in (bxc, bxs, ybasis))


@dft.ieee_f32()
def _corr_windows(prods: torch.Tensor, nx: int, ny: int, hx: int,
                  hy: int, row0: int = 0) -> torch.Tensor:
    """Centred lag windows ``[planes, 2hx+1, 2hy+1]`` of the circular
    cross-correlations whose half-spectra are ``prods [planes, nx, nyr]``
    (complex).  ``prods`` may hold grid rows ``row0 .. row0 + rows`` only
    (``[planes, rows, nyr]``): the windows are then those rows' partial
    sums.

    The y-stage runs as ONE stacked real product
    ``[p·nx, 2·nyr] @ [2·nyr, 2·vy]`` computing [sr si] together; the
    x-stage output is window-sized.
    """
    bxc, bxs, ybasis = _lag_bases_on(nx, ny, hx, hy, prods.device)
    p, rows = prods.shape[0], prods.shape[1]
    vy = 2 * hy + 1
    ops = torch.cat([prods.real, prods.imag], dim=-1)       # [p, rows, 2nyr]
    s = (ops.reshape(p * rows, ops.shape[-1]) @ ybasis).reshape(
        p, rows, 2 * vy)
    return _combine_windows(s[..., :vy], s[..., vy:],
                            bxc[row0:row0 + rows], bxs[row0:row0 + rows])


def _mean_products(X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``mean_b conj(X[b,d])·Z[b,e]`` as ``[D·E, nx, nyr]`` planes."""
    prods = torch.mean(X.conj()[:, :, None] * Z[:, None], dim=0)
    return prods.reshape(X.shape[1] * Z.shape[1], X.shape[-2], X.shape[-1])


# ------------------------------------------------------------------- K3

def corr_pair_windows_plain(X: torch.Tensor, Z: torch.Tensor, nx: int,
                            ny: int, hx: int, hy: int) -> torch.Tensor:
    """Plain version of :func:`corr_pair_windows`: the batch-mean products
    ``mean_b conj(X)·Z`` followed by :func:`_corr_windows`."""
    D, E = X.shape[1], Z.shape[1]
    return _corr_windows(_mean_products(X, Z), nx, ny, hx, hy).reshape(
        D, E, 2 * hx + 1, 2 * hy + 1)


def _check_mixed(name: str, X, nx: int, ny: int) -> None:
    """``X`` must be the ``(Xre, Xim)`` planes of ``rfft2_mixed``."""
    if not (isinstance(X, (tuple, list)) and len(X) == 2):
        raise TypeError(f"{name}(mixed=True): X must be the (Xre, Xim) pair "
                        "of rfft2_mixed")
    re, im = X
    if (re.dtype not in (torch.float32, torch.bfloat16)
            or im.dtype != re.dtype or re.dim() != 4
            or im.shape != re.shape or im.device != re.device):
        raise TypeError(f"{name}(mixed=True): Xre, Xim must be float32 or "
                        f"bfloat16 [B, C, nx, lanes] alike, got {re.dtype} "
                        f"{tuple(re.shape)} and {im.dtype} {tuple(im.shape)}")
    lanes = fft_kernels.ny_padded(ny)
    if re.shape[-2:] != (nx, lanes):
        raise ValueError(f"{name}(mixed=True): planes {tuple(re.shape)} do "
                         f"not match nx={nx}, ny={ny} ({lanes} mixed lanes; "
                         "pass the rfft2_mixed output unsliced)")


def _check_spectra(name: str, X: torch.Tensor, nx: int, ny: int,
                   slab: bool = False) -> None:
    """``X`` must be complex64 ``[B, C, nx, nyr]`` spectra, or with
    ``slab`` a ``[B, C, rows, nyr]`` row slab of them."""
    if X.dtype != torch.complex64 or X.dim() != 4:
        raise TypeError(f"{name}: spectra must be complex64 [B, C, nx, nyr], "
                        f"got {X.dtype} {tuple(X.shape)}")
    if X.shape[-1] != ny // 2 + 1 or X.shape[-2] < 1 or (
            not slab and X.shape[-2] != nx):
        raise ValueError(f"{name}: spectra {tuple(X.shape)} do not match "
                         f"nx={nx}, ny={ny} (nyr={ny // 2 + 1})")


# K3/K4's launch plan (window_plan): the constants measured best at the
# precompute's shapes (scripts/torch_windows_bench.py --sweep)
_SMEM_LIMIT, _BLOCK_THREADS, _MAX_THREADS = 232448, 256, 512
_ROWS, _MIN_YCHUNK, _YTILE, _STEP_BINS = 16, 8, 16, 16
_MIN_BLOCKS, _MIN_THREADS = 256, 48 * 1024


class WindowPlan(NamedTuple):
    """One K3 or K4 launch: ``rows`` x-rows, ``batches`` batches and
    ``ychunk`` ω_y bins a block, walked in steps of ``ytile`` bins;
    ``threads`` a block, the ``grid`` (row tiles, batch groups, ω_y
    chunks), the block's shared memory in bytes and the scratch floats of
    the block partials."""
    rows: int
    batches: int
    ychunk: int
    ytile: int
    threads: int
    grid: tuple[int, int, int]
    smem: int
    scratch: int


def _cols_per_thread(h: int) -> int:
    """Lag columns v ≥ 0 a thread takes for a half-extent ``h``: one chunk
    of 3, 5 or 9, else chunks of 8 (the C side's ``cols_per_thread``)."""
    nv = h + 1
    return 3 if nv <= 3 else 5 if nv <= 5 else 9 if nv <= 9 else 8


def _pow2_at_most(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _groups(anchor: bool, D: int, E: int, hx: int, hy: int, same: bool):
    """(pairs, hx, hy) of each window extent: K4's XX (±2h, the upper
    pairs) and EG (±h) windows, or K3's one."""
    if anchor:
        return ((D * (D + 1) // 2, 2 * hx, 2 * hy), (D * D, hx, hy))
    return ((D * (D + 1) // 2 if same else D * E, hx, hy),)


def _layout(groups, anchor: bool, D: int, E: int, same: bool, hx: int,
            hy: int, rows: int, batches: int, ychunk: int, ytile: int):
    """Threads, shared-memory floats and x-stage units of a block (the C
    side's ``layout``)."""
    threads = pcol = soff = nxu = nvs = 0
    for npairs, hx_g, hy_g in groups:
        nvt = _cols_per_thread(hy_g)
        nvch = _cdiv(hy_g + 1, nvt)
        threads += 32 * _cdiv(npairs * nvch * rows, 32)
        pcol += npairs * rows
        soff += npairs * (hy_g + 1)
        nxu += npairs * (hx_g + 1) * (hy_g + 1)
        nvs = max(nvs, nvch * nvt)
    want = 16 // ytile if ytile < 16 else 1
    pstride = pcol + (want - pcol) % 16
    ypad = _cdiv(ychunk, ytile) * ytile
    dd = D * D
    floats = (ypad * _round4(2 * nvs) + rows * _round4(2 * (groups[0][1] + 1))
              + _round4(max(batches * ytile * pstride * 2,
                            soff * (rows + 1) * 4))
              + _round4(threads // 32) + _round4(batches * D))
    # two buffers of one step's signal (complex64, or bf16 re/im rows of
    # the same bytes)
    chans = D + (0 if anchor or same else E)
    floats += 2 * _round4(batches * chans * rows * 2 * ytile)
    if anchor:
        floats += (ypad * _round4(2 * hy + 1)
                   + _round4(dd * (2 * hx + 1) * (2 * hy + 1))
                   + rows * dd * (hy + 1) * 4 + _round4(dd * rows * ytile * 2))
    return threads, floats, nxu


@functools.lru_cache(maxsize=512)
def window_plan(anchor: bool, B: int, D: int, E: int, nx: int, nyr: int,
                hx: int, hy: int, same: bool = False) -> WindowPlan:
    """K3's (``anchor=False``: pairs of ``D`` and ``E`` channels, or the
    upper pairs of ``D`` when ``same``, at ±hx, ±hy) or K4's (``anchor=
    True``: ``hx, hy`` the composed taps' half-extents, windows at ±2h and
    ±h) launch plan over ``[B, ·, nx, nyr]`` spectra, from the shape alone.

    A thread owns one (pair, x-row) of a window extent and all its lag
    columns (up to 9 of v ≥ 0; more in chunks of 8), so a block of ``rows``
    x-rows has ``rows`` threads a pair: 16 rows, fewer (a power of two)
    where that passes 256 threads.  The grid then splits ω_y into chunks
    of at least 8 bins until it has 256 blocks and 48 K threads; a grid
    still under 256 blocks takes blocks of 8 rows, then splits the batch.
    A block walks its chunk in steps of 16 // batches bins (at least 1).
    Where the chunk's bases, signal and products pass the 227 KB of shared
    memory a block may have, the steps, the batches and then the chunk
    shrink.
    """
    if min(B, D, E, nx, nyr) < 1 or min(hx, hy) < 0:
        raise ValueError(f"window_plan: B={B} D={D} E={E} nx={nx} "
                         f"nyr={nyr} hx={hx} hy={hy}")
    groups = _groups(anchor, D, E, hx, hy, same)

    def layout(rows, batches=1, ychunk=1, ytile=1):
        return _layout(groups, anchor, D, E, same, hx, hy, rows, batches,
                       ychunk, ytile)

    def blocks():
        return _cdiv(nx, rows) * _cdiv(B, batches) * _cdiv(nyr, ychunk)
    rows = min(_ROWS, _pow2_at_most(nx))
    while rows > 1 and layout(rows)[0] > _BLOCK_THREADS:
        rows //= 2
    threads = layout(rows)[0]
    if threads > _MAX_THREADS:
        raise ValueError(
            f"{'anchor_windows' if anchor else 'corr_pair_windows'}: "
            f"{sum(g[0] for g in groups)} pairs need more than "
            f"{_MAX_THREADS} threads for one x-row")
    batches, ychunk = B, nyr
    while (blocks() < max(_MIN_BLOCKS, _MIN_THREADS // threads)
           and ychunk > _MIN_YCHUNK):
        ychunk = max(_MIN_YCHUNK, min(
            ychunk - 1, _cdiv(nyr, _cdiv(nyr, ychunk) + 1)))
    if blocks() < _MIN_BLOCKS:
        rows = min(rows, 8)
    while blocks() < _MIN_BLOCKS and batches > 1:
        batches = _cdiv(batches, 2)
    ytile = _pow2_at_most(min(_YTILE, _STEP_BINS // batches))
    while layout(rows, batches, ychunk, ytile)[1] * 4 > _SMEM_LIMIT:
        if batches * ytile > 8:
            if ytile > 1:
                ytile //= 2
            else:
                batches = _cdiv(batches, 2)
        elif ychunk > 1:
            ychunk = _cdiv(ychunk, 2)
            ytile = _pow2_at_most(min(ytile, ychunk))
        else:
            raise ValueError(f"window_plan: no tiling of B={B} D={D} E={E} "
                             f"nx={nx} nyr={nyr} fits the shared memory")
    return plan_of(anchor, B, D, E, nx, nyr, hx, hy, same, rows, batches,
                   ychunk, ytile)


def plan_of(anchor: bool, B: int, D: int, E: int, nx: int, nyr: int, hx: int,
            hy: int, same: bool, rows: int, batches: int, ychunk: int,
            ytile: int) -> WindowPlan:
    """The :class:`WindowPlan` of given tiles (threads, grid, shared memory
    and scratch follow from them); raises where they cannot run."""
    if rows & (rows - 1) or ytile & (ytile - 1):
        raise ValueError(f"window_plan: rows={rows} and ytile={ytile} must "
                         "be powers of two")
    groups = _groups(anchor, D, E, hx, hy, same)
    threads, floats, nxu = _layout(groups, anchor, D, E, same, hx, hy, rows,
                                   batches, ychunk, ytile)
    grid = (_cdiv(nx, rows), _cdiv(B, batches), _cdiv(nyr, ychunk))
    if (threads > _MAX_THREADS or floats * 4 > _SMEM_LIMIT
            or max(grid[1:]) > _GRID_YZ):
        raise ValueError(f"window_plan: {rows} rows x {batches} batches x "
                         f"{ychunk} bins (steps of {ytile}) cannot run: "
                         f"{threads} threads, {floats * 4} bytes, grid "
                         f"{grid}")
    nblk = grid[0] * grid[1] * grid[2]
    return WindowPlan(rows, batches, ychunk, ytile, threads, grid,
                      floats * 4, 4 * nxu * nblk + nblk + grid[1] * D)


def _ybasis(nx: int, ny: int, hy: int, cols: int) -> np.ndarray:
    """``(w cos, w sin)`` of 2π ω_y v / ny for v = 0..hy, interleaved,
    zero to ``cols`` floats a row: the right half of
    :func:`dft.lag_basis`'s y bases."""
    _, _, byc, bys = dft.lag_basis(nx, ny, 0, hy)
    out = np.zeros((byc.shape[0], cols), np.float32)
    out[:, 0:2 * (hy + 1):2] = byc[:, hy:]
    out[:, 1:2 * (hy + 1):2] = bys[:, hy:]
    return out


def _xbasis(nx: int, ny: int, hx: int) -> np.ndarray:
    """``(cos, sin)`` of 2π ω_x u / nx for u = 0..hx, interleaved, rows
    padded to 16 bytes: the right half of :func:`dft.lag_basis`'s x
    bases."""
    bxc, bxs, _, _ = dft.lag_basis(nx, ny, hx, 0)
    out = np.zeros((nx, _round4(2 * (hx + 1))), np.float32)
    out[:, 0:2 * (hx + 1):2] = bxc[:, hx:]
    out[:, 1:2 * (hx + 1):2] = bxs[:, hx:]
    return out


@functools.lru_cache(maxsize=None)
def _consts_on(kind: str, nx: int, ny: int, a: int, b: int,
               device: torch.device) -> torch.Tensor:
    """The packed float32 constants of a kernel's entry point (the layout
    its C signature states), kept on ``device``.  ``pair``: ``a, b`` are
    the window half-extents; ``anchor``: the composed taps' half-extents
    (one lag basis at ±2b serves both of K4's windows)."""
    hx, hy = (a, b) if kind == "pair" else (2 * a, 2 * b)
    groups = _groups(kind == "anchor", 1, 1, a, b, False)
    nvs = max(_cdiv(g[2] + 1, _cols_per_thread(g[2])) * _cols_per_thread(
        g[2]) for g in groups)
    parts = [_ybasis(nx, ny, hy, _round4(2 * nvs)), _xbasis(nx, ny, hx)]
    if kind == "anchor":
        _, _, cy, sy, w = dft._axis_bases(2 * a + 1, 2 * b + 1, nx, ny)
        yanc = np.zeros((ny // 2 + 1, _round4(2 * b + 1)), np.float32)
        yanc[:, 0:2 * b:2] = cy[b + 1:].T
        yanc[:, 1:2 * b:2] = sy[b + 1:].T
        yanc[:, 2 * b] = w
        parts.append(yanc)
    flat = np.concatenate([np.asarray(p, np.float32).ravel() for p in parts])
    with torch.inference_mode(False):
        return torch.as_tensor(flat, device=device)


@_kernels.opaque
def corr_pair_windows(X: torch.Tensor, Z: torch.Tensor, nx: int, ny: int,
                      hx: int, hy: int) -> torch.Tensor:
    """Batch-mean centred lag windows of ``conj(X[b,d])·Z[b,e]`` (K3).

    X: ``[B, D, nx, nyr]`` complex64; Z: ``[B, E, nx, nyr]`` complex64 (pass
    the SAME tensor for the autocorrelation case — the kernel then reads
    one input and forms the pairs d ≤ e only, mirroring the others as
    ``W[e,d](l) = W[d,e](−l)``).  Returns ``[D, E, 2hx+1, 2hy+1]`` float32, equal to float32
    tolerance to::

        _corr_windows(mean_b(conj(X)[:, :, None] * Z[:, None]), ...)

    CPU tensors take :func:`corr_pair_windows_plain`; CUDA tensors launch
    the kernel.
    """
    _check_spectra("corr_pair_windows", X, nx, ny)
    _check_spectra("corr_pair_windows", Z, nx, ny)
    if X.shape[0] != Z.shape[0] or X.device != Z.device:
        raise ValueError(f"X {tuple(X.shape)} on {X.device} and Z "
                         f"{tuple(Z.shape)} on {Z.device} do not pair")
    if X.device.type == "cpu":
        return corr_pair_windows_plain(X, Z, nx, ny, hx, hy)
    if X.device.type != "cuda":
        raise ValueError(f"corr_pair_windows runs on cpu or cuda, not "
                         f"{X.device}")
    same = Z is X
    X = X.resolve_conj().contiguous()
    Z = X if same else Z.resolve_conj().contiguous()
    B, D, _, nyr = X.shape
    E = Z.shape[1]
    plan = window_plan(False, B, D, E, nx, nyr, hx, hy, same)
    out = torch.empty((D, E, 2 * hx + 1, 2 * hy + 1), dtype=torch.float32,
                      device=X.device)
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=X.device)
    _kernels.launch(
        "corr_pair_windows_launch", "corr_pair_windows", X.device,
        X.data_ptr(), Z.data_ptr(),
        _consts_on("pair", nx, ny, hx, hy, X.device).data_ptr(),
        out.data_ptr(), scratch.data_ptr(), plan.scratch, B, D, E, nx, nyr,
        hx, hy, int(same), plan.rows, plan.batches, plan.ychunk, plan.ytile,
        plan.smem)
    return out


# ------------------------------------------------------------------- K4

def _round_signal(X: torch.Tensor, signal_dtype) -> torch.Tensor:
    """``X`` with its real and imaginary planes rounded to
    ``signal_dtype`` and back to float32."""
    return torch.complex(X.real.to(signal_dtype).float(),
                         X.imag.to(signal_dtype).float())


@dft.ieee_f32()
def anchor_windows_plain(X: torch.Tensor, K0taps: torch.Tensor, nx: int,
                         ny: int, hx2: int, hy2: int, s1: float, *,
                         row_slab: int | None = None, signal_dtype=None,
                         mixed: bool = False):
    """Plain version of :func:`anchor_windows`: the XLA branch of the JAX
    package's fused precompute (fft_corr.py:504-527) with
    :func:`anchor_windows`'s outputs.  The anchor spectra and the EG planes
    are materialised at full resolution.

    ``row_slab``: ``X`` holds grid rows ``row_slab ..`` only; the rows at
    or past ``nx`` are left out, and the outputs are the slab's partial
    sums (``e0`` is 0 unless the slab holds row 0).  ``signal_dtype``:
    round the signal's real and imaginary planes to it first (the bf16
    signal route of the kernel).  ``mixed``: ``X`` is the ``(Xre, Xim)``
    pair of ``rfft2_mixed``, gathered to natural order first.
    """
    if mixed:
        X = fft_kernels.to_natural(X, nx, ny)
    row0 = 0 if row_slab is None else int(row_slab)
    rows = max(0, min(X.shape[-2], nx - row0))
    X = X[:, :, :rows]
    if signal_dtype is not None:
        X = _round_signal(X, signal_dtype)
    D = X.shape[1]
    hx4, hy4 = 2 * hx2, 2 * hy2
    K0f = dft.kernel_spectrum(K0taps, nx, ny, precision="high")[
        ..., row0:row0 + rows, :]
    wv = torch.as_tensor(_hermitian_weights(nx, ny), device=X.device)
    # the continuum error, bin by bin (the anchoring precision invariant):
    # an elementwise multiply-reduce over d, no matmul
    EG = torch.sum(K0f[None] * X[:, None], dim=2) * s1 - X
    XX = _corr_windows(_mean_products(X, X), nx, ny, hx4, hy4, row0)
    EGw = _corr_windows(_mean_products(X, EG), nx, ny, hx2, hy2, row0)
    seg = torch.mean(torch.sum((EG.real ** 2 + EG.imag ** 2) * wv,
                               dim=(-3, -2, -1)))
    e0 = (torch.mean(EG[:, :, 0, 0].real, dim=0) if row0 == 0 and rows
          else X.real.new_zeros(D))
    return (XX.reshape(D, D, 2 * hx4 + 1, 2 * hy4 + 1),
            EGw.reshape(D, D, 2 * hx2 + 1, 2 * hy2 + 1), seg, e0)


@_kernels.opaque
def anchor_windows(X: torch.Tensor, K0taps: torch.Tensor, nx: int, ny: int,
                   hx2: int, hy2: int, s1: float, *, row_slab=None,
                   signal_dtype=None, mixed: bool = False):
    """Whole fused-anchor precompute pass in one kernel (K4).

    Given the signal half-spectra ``X [B, D, nx, nyr]`` and the composed
    anchor taps ``K0taps [D, D, 2hx2+1, 2hy2+1]``, returns

    - ``XX  [D, D, 4hx2+1, 4hy2+1]`` — lag windows of conj(X_d)·X_e,
    - ``EGw [D, D, 2hx2+1, 2hy2+1]`` — lag windows of conj(X_d)·EG_e,
    - ``seg`` — mean_b Σ_ω w·|EG|² (summed over channels),
    - ``e0  [D]`` — mean_b EG[b, :, 0, 0].real,

    where ``EG = s1·K̂₀X − X`` is the continuum anchor error
    (:func:`spectralae_torch.train.fft_corr.corr_precompute_fused`).

    ``signal_dtype=torch.bfloat16``: the kernel reads the signal's re/im
    planes rounded to bf16 (half the bytes); every product and sum stays
    float32, and EG is the exact continuum error of the rounded signal.
    The kernel splits ω_y into chunks of its own where a row does not fit
    in its shared memory (the JAX package's ``y_chunk`` VMEM budget has no
    counterpart here).

    ``mixed``: ``X`` is the ``(Xre, Xim)`` pair of
    :func:`~spectralae_torch.ops.fft_kernels.rfft2_mixed`, float32 or bf16
    planes, rows in ``perm_x`` and lanes in ``perm_y`` order.  One gather
    per plane (:func:`~spectralae_torch.ops.fft_kernels.gather_natural`)
    brings them to natural order: float32 planes become complex64, bf16
    planes stay bf16 planes and take the bf16 signal route.

    ``row_slab``: a global start row (the tensor-parallel precompute,
    :func:`~spectralae_torch.train.fft_corr.corr_precompute_fused` under
    ``model_axis``).  ``X`` is then an x-row *slab* ``[B, D, nx_l, nyr]``
    of the full spectra, rows ``row_slab .. row_slab + nx_l`` (rows at or
    past ``nx``, the zero padding of an end slab, are not read), and the
    outputs are the slab's **partial sums**: every one is linear (the
    windows) or additive (``seg``) over the x-rows, so the partials of a
    disjoint cover of ``[0, nx)`` sum to the full call up to float32
    rounding.  ``e0`` is the slab's DC error: 0 unless it holds row 0.
    The kernel reads each row's phases and bases at its global row.

    CPU tensors take :func:`anchor_windows_plain`; CUDA tensors launch the
    kernel.
    """
    if mixed and row_slab is not None:
        raise ValueError("mixed-order X has no row-slab (TP) variant")
    row0 = 0 if row_slab is None else int(row_slab)
    if row0 < 0:
        raise ValueError(f"row_slab must be >= 0, got {row_slab}")
    if mixed:
        _check_mixed("anchor_windows", X, nx, ny)
        B, D = X[0].shape[:2]
        device = X[0].device
    else:
        _check_spectra("anchor_windows", X, nx, ny,
                       slab=row_slab is not None)
        B, D = X.shape[:2]
        device = X.device
    nk2, nl2 = K0taps.shape[-2], K0taps.shape[-1]
    if tuple(K0taps.shape) != (D, D, 2 * hx2 + 1, 2 * hy2 + 1):
        raise ValueError(
            f"hx2/hy2 must be the composed-tap half-extents of [D, D] taps: "
            f"K0taps is {tuple(K0taps.shape)}, D={D}, hx2={hx2}, hy2={hy2}")
    if signal_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"signal_dtype must be None, float32 or bfloat16, "
                        f"not {signal_dtype}")
    if signal_dtype == torch.float32:
        signal_dtype = None
    if device.type == "cpu":
        return anchor_windows_plain(X, K0taps, nx, ny, hx2, hy2, s1,
                                    row_slab=row_slab,
                                    signal_dtype=signal_dtype, mixed=mixed)
    if device.type != "cuda":
        raise ValueError(f"anchor_windows runs on cpu or cuda, not {device}")
    taps = K0taps.to(device=device, dtype=torch.float32).contiguous()
    nyr = ny // 2 + 1
    # the signal as corr_windows.cu reads it: interleaved complex64, or
    # split bf16 re/im planes
    if mixed:
        re, im = fft_kernels.gather_natural(X, nx, ny)
        if re.dtype == torch.float32 and signal_dtype is None:
            X, planes = torch.complex(re, im), None
        else:
            planes = [re.to(torch.bfloat16), im.to(torch.bfloat16)]
    elif signal_dtype is not None:
        X = X.resolve_conj()
        planes = [X.real.to(torch.bfloat16).contiguous(),
                  X.imag.to(torch.bfloat16).contiguous()]
    else:
        X, planes = X.resolve_conj().contiguous(), None
    ptrs = ((X.data_ptr(), None, None) if planes is None
            else (None, planes[0].data_ptr(), planes[1].data_ptr()))
    nx_l = X.shape[-2] if planes is None else planes[0].shape[-2]
    plan = window_plan(True, B, D, D, nx_l, nyr, hx2, hy2)
    vx4, vy4, vx2, vy2 = 2 * nk2 - 1, 2 * nl2 - 1, nk2, nl2
    n_xx, n_eg = D * D * vx4 * vy4, D * D * vx2 * vy2
    out = torch.empty(n_xx + n_eg + 1 + D, dtype=torch.float32,
                      device=device)
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=device)
    _kernels.launch(
        "anchor_windows_launch", "anchor_windows", device, *ptrs,
        taps.data_ptr(),
        _consts_on("anchor", nx, ny, hx2, hy2, device).data_ptr(),
        out.data_ptr(), scratch.data_ptr(), plan.scratch, B, D, nx, nx_l,
        row0, nyr, nk2, nl2, float(s1), int(planes is not None), plan.rows,
        plan.batches, plan.ychunk, plan.ytile, plan.smem)
    return (out[:n_xx].reshape(D, D, vx4, vy4),
            out[n_xx:n_xx + n_eg].reshape(D, D, vx2, vy2),
            out[n_xx + n_eg], out[n_xx + n_eg + 1:])
