"""Hand-written CUDA kernels for the omega-space burst engines (K5-K8).

Counterpart of the Pallas bodies of :mod:`spectralae.train.fft_pallas` and
:mod:`spectralae.train.fft_iter`.  One frozen-input burst trains a stage
pair's compact kernels against the half-spectra of its frames; each kernel
sweeps the ``W = nx·(ny/2+1)`` bins, rebuilding the kernel spectra from the
compact kernels through the restricted-DFT basis ``[2, P, W]`` (cos, sin)
and projecting the gradient spectra back onto it, so no full-size spectrum
of the kernels or of their gradients is stored:

- K5 :func:`grad_project`: the projected gradients ``g [2·M·D, P]`` and the
  DC-bin bias gradients from the current output spectrum O;
- K6 :func:`respectra_conv`: the two-stage conv's O and the Hermitian-
  weighted MSE sum;
- K7 :func:`fused_step`: K6 and then K5 on the fresh O, in one sweep;
- K8 :func:`itergrid`: the whole burst, inertia updates included, in one
  cooperative launch.

Layouts: ``planes [k, nb·D, W]`` float32 stacks the re/im planes of X, Y
(and O for K5, K8: ``k = 6``; K6, K7 read the first 4); ``cf [2·M·D, P]``
stacks c (rows ``m·D+d``) over f (rows ``d·M+m``); ``wv [W]`` the Hermitian
weights.  All live in ``csrc/omega_burst.cu``, whose header note says what
bounds them and how.  Each has a plain PyTorch version here, which the
wrappers run for CPU tensors; for CUDA tensors they launch the kernel or
raise.  Each launch is one grid: K5, K6 and K7 sum their tiles' partials
in a fixed order inside it, K8 (a cooperative launch) between grid
barriers every iteration.

``mxu_bf16`` rounds the operands of the four basis products to bf16 and
sums in float32 (the JAX ``mxu_dtype=bfloat16``); every other product is
IEEE float32, and the plain versions' matmuls run with TF32 off.  All four
kernels run their basis products on the tensor cores at the tiers of
:data:`TC_TIERS` (never TF32), from the bf16 pieces :func:`basis_tiles`
lays out once per basis tensor (:func:`_tiles`): K5, K7 and K8 read both
copies of a tile record, K6 only the rebuild's, so the engines share one
layout.
"""

from __future__ import annotations

import torch

from .. import _kernels
from . import dft, fft_kernels
from ..optim.update import burst_inertia

# the shapes the kernels take (csrc/omega_burst.cu: kMaxD, kMaxP ·
# kMaxChunks, kMaxRows)
_MAX_D, _MAX_P, _MAX_ROWS = 4, 256, 64

#: the tensor-core sweep of K5-K8 (csrc/omega_burst.cu kTB, kTG, kMaxP):
#: bins a tile, tiles a group of the fixed-order sum of their partials, and
#: taps a chunk of the contraction over p (13×13 kernels take six chunks)
TC_TILE, TC_GROUP, TC_TAPS = 64, 16, 32
#: the JAX dot tiers of K5-K8's basis products on the tensor cores,
#: (spectra rebuild, projection), by ``mxu_bf16``: one bf16 product (the
#: JAX ``mxu_dtype``) for bf16 operands; for float32 ones bf16×6
#: ("highest") for the rebuild, where bf16×3 leaves O 8–9e-6 from the
#: float32 product, and bf16×3 ("high") for the projection, 2–4e-6 on g
#: (tests/test_torch_omega_tc.py)
TC_TIERS = {False: ("highest", "high"), True: ("default", "default")}


def basis_tiles(basis: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The basis ``[2, P, W]`` as the tensor-core sweep's tiles: per
    tile of :data:`TC_TILE` bins, the rebuild's copy (``[bin][p]``, p the
    contraction) split into its tier's bf16 pieces, then the projection's
    (``[p][bin]``, bins the contraction) into its tier's
    (:data:`TC_TIERS`), each copy chunk by chunk of :data:`TC_TAPS` taps,
    each chunk piece by piece, each piece cos then sin, P padded to whole
    chunks and W to whole tiles with zeros, in the kernels' core-matrix
    order (``csrc/wgmma.cuh``): ``[tiles, chunks · pieces · 2 · TC_TAPS ·
    TC_TILE]`` bf16.  One chunk (P <= 32) is the layout of one copy of
    pieces."""
    _, P, W = basis.shape
    nt, nc = -(-W // TC_TILE), -(-P // TC_TAPS)
    with torch.inference_mode(False):
        z = basis.new_zeros(2, nc * TC_TAPS, nt * TC_TILE)
        z[:, :P, :W] = basis
        pt = z.reshape(2, nc, TC_TAPS, nt, TC_TILE).permute(3, 1, 0, 2, 4)
        out = []                                        # pt: t,c,cs,p,u
        for copy, prec in zip((pt.transpose(-1, -2), pt), TC_TIERS[bf16]):
            pieces = fft_kernels.pieces(copy, fft_kernels._TIERS[prec] + 1)
            out.append(torch.stack([fft_kernels.core_order(
                piece.to(torch.bfloat16)) for piece in pieces], 2)
                .reshape(nt, -1))                       # t,c,piece,cs,x
        return torch.cat(out, 1).contiguous()


def _mx(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``t`` as a basis-product operand: rounded to bf16 (and back) when
    ``bf16``, so a float32 product sums exact bf16 values in float32."""
    return t.to(torch.bfloat16).float() if bf16 else t


def _dims(planes, cf, b):
    """(nb, M, D, W) from the operands' shapes."""
    M = b.shape[0]
    D = cf.shape[0] // (2 * M)
    return planes.shape[1] // D, M, D, planes.shape[-1]


def _spectra(basis, cf, bf16):
    """Kernel spectra of every row of ``cf`` at every bin: (re, im)
    ``[2·M·D, W]``, re = cf·cos, im = −cf·sin."""
    k = _mx(cf, bf16)
    return k @ _mx(basis[0], bf16), -(k @ _mx(basis[1], bf16))


def _split_spectra(allr, alli, M, D, W):
    """(cfr, cfi [M, D, W], ffr, ffi [D, M, W])."""
    md = M * D
    return (allr[:md].reshape(M, D, W), alli[:md].reshape(M, D, W),
            allr[md:].reshape(D, M, W), alli[md:].reshape(D, M, W))


def _contract_h(cfr, cfi, xr, xi):
    """``Σ_d Cf[m,d]·X[b,d]`` as (re, im) ``[nb, M, W]``."""
    return ((cfr[None] * xr[:, None] - cfi[None] * xi[:, None]).sum(2),
            (cfr[None] * xi[:, None] + cfi[None] * xr[:, None]).sum(2))


def _conv_out(ffr, ffi, hr, hi, p, norm):
    """``Σ_m Ff[d,m]·H[b,m]`` (+ p·N at the DC bin) as (re, im)
    ``[nb, D, W]``."""
    our = (ffr[None] * hr[:, None] - ffi[None] * hi[:, None]).sum(2)
    oui = (ffr[None] * hi[:, None] + ffi[None] * hr[:, None]).sum(2)
    our[..., 0] += p * norm
    return our, oui


def _grad_products(er, ei, xr, xi, hr, hi, ffr, ffi, wv):
    """The gradient spectra ``dc [M·D, W]`` and ``df [D·M, W]`` stacked as
    (d_re, d_im) ``[2·M·D, W]``, and S ``[nb, M, W]`` (re, im); ``wv`` is
    applied to the sums over frames (None: E is weighted already)."""
    sr = (er[:, :, None] * ffr[None] + ei[:, :, None] * ffi[None]).sum(1)
    si = (ei[:, :, None] * ffr[None] - er[:, :, None] * ffi[None]).sum(1)
    dcr = (sr[:, :, None] * xr[:, None] + si[:, :, None] * xi[:, None]).sum(0)
    dci = (si[:, :, None] * xr[:, None] - sr[:, :, None] * xi[:, None]).sum(0)
    dfr = (er[:, :, None] * hr[:, None] + ei[:, :, None] * hi[:, None]).sum(0)
    dfi = (ei[:, :, None] * hr[:, None] - er[:, :, None] * hi[:, None]).sum(0)
    if wv is not None:
        dcr, dci, dfr, dfi = (t * wv for t in (dcr, dci, dfr, dfi))
    W = er.shape[-1]
    return (torch.cat([dcr.reshape(-1, W), dfr.reshape(-1, W)]),
            torch.cat([dci.reshape(-1, W), dfi.reshape(-1, W)]), sr)


def _project(d_re, d_im, basis, bf16):
    """``d_re·cosᵀ − d_im·sinᵀ`` ``[rows, P]``: the gradient spectra
    projected onto the compact support."""
    return (_mx(d_re, bf16) @ _mx(basis[0], bf16).T
            - _mx(d_im, bf16) @ _mx(basis[1], bf16).T)


def _bias_grads(sr, er, norm, scale):
    """db [M], dp [D] from the DC bin of S and E, summed over frames."""
    return (sr[:, :, 0].sum(0) * norm * scale,
            er[:, :, 0].sum(0) * norm * scale)


def _frames(planes, nb, D, W):
    return [pl.reshape(nb, D, W) for pl in planes]


# ----------------------------------------------------- plain versions

@dft.ieee_f32()
def grad_project_plain(planes, basis, wv, cf, b, *, norm: float,
                       scale: float, mxu_bf16: bool = False):
    """Plain version of :func:`grad_project` (``_grad_project_kernel``):
    returns ``g [2·M·D, P]``, ``db [M]``, ``dp [D]``."""
    nb, M, D, W = _dims(planes, cf, b)
    cfr, cfi, ffr, ffi = _split_spectra(*_spectra(basis, cf, mxu_bf16), M, D,
                                        W)
    xr, xi, yr, yi, orr, oii = _frames(planes[:6], nb, D, W)
    er, ei = orr - yr, oii - yi
    hr, hi = _contract_h(cfr, cfi, xr, xi)
    hr[..., 0] += b * norm
    d_re, d_im, sr = _grad_products(er, ei, xr, xi, hr, hi, ffr, ffi, wv)
    g = _project(d_re, d_im, basis, mxu_bf16) * scale
    return (g, *_bias_grads(sr, er, norm, scale))


@dft.ieee_f32()
def respectra_conv_plain(planes, basis, wv, cf, b, p, *, norm: float,
                         inv_m: float, inv_d: float, mxu_bf16: bool = False):
    """Plain version of :func:`respectra_conv` (``_respectra_conv_kernel``):
    returns ``O [2, nb·D, W]`` (re, im) and ``Σ w|O − Y|² / nb``."""
    nb, M, D, W = _dims(planes, cf, b)
    cfr, cfi, ffr, ffi = _split_spectra(*_spectra(basis, cf, mxu_bf16), M, D,
                                        W)
    xr, xi, yr, yi = _frames(planes[:4], nb, D, W)
    hr, hi = _contract_h(cfr, cfi, xr * inv_m, xi * inv_m)
    hr[..., 0] += b * norm
    our, oui = _conv_out(ffr, ffi, hr * inv_d, hi * inv_d, p, norm)
    mse = torch.sum(((our - yr) ** 2 + (oui - yi) ** 2) * wv) / nb
    return torch.stack([our.reshape(nb * D, W), oui.reshape(nb * D, W)]), mse


def _fused(planes, basis, wv, cf, b, p, norm, inv_m, inv_d, scale, bf16,
           given_o: bool, weighted_e: bool):
    """One sweep of K7 (``given_o`` False: O from the forward; E raw, wv on
    the products) or of an iteration of K8 (``weighted_e``: E·wv before
    the products; ``given_o`` at its iteration 0).  Returns O (None when
    given), the MSE sum, g, db, dp."""
    nb, M, D, W = _dims(planes, cf, b)
    cfr, cfi, ffr, ffi = _split_spectra(*_spectra(basis, cf, bf16), M, D, W)
    xr, xi, yr, yi = _frames(planes[:4], nb, D, W)
    h0r, h0i = _contract_h(cfr, cfi, xr, xi)
    bias = torch.zeros_like(h0r)
    bias[..., 0] = b * norm
    O = None
    if given_o:
        our, oui = _frames(planes[4:6], nb, D, W)
    else:
        our, oui = _conv_out(ffr, ffi, (h0r * inv_m + bias) * inv_d,
                             h0i * inv_m * inv_d, p, norm)
        O = torch.stack([our.reshape(nb * D, W), oui.reshape(nb * D, W)])
    er, ei = our - yr, oui - yi
    if weighted_e:
        erw, eiw = er * wv, ei * wv
        mse = torch.sum(er * erw + ei * eiw) / nb
        er, ei = erw, eiw
    else:
        mse = torch.sum((er ** 2 + ei ** 2) * wv) / nb
    d_re, d_im, sr = _grad_products(er, ei, xr, xi, h0r + bias, h0i, ffr,
                                    ffi, None if weighted_e else wv)
    g = _project(d_re, d_im, basis, bf16) * scale
    return (O, mse, g, *_bias_grads(sr, er, norm, scale))


@dft.ieee_f32()
def fused_step_plain(planes, basis, wv, cf, b, p, *, norm: float,
                     inv_m: float, inv_d: float, scale: float,
                     mxu_bf16: bool = False):
    """Plain version of :func:`fused_step` (``_fused_step_kernel``):
    returns O, the MSE sum, g, db, dp."""
    return _fused(planes, basis, wv, cf, b, p, norm, inv_m, inv_d, scale,
                  mxu_bf16, given_o=False, weighted_e=False)


@dft.ieee_f32()
def itergrid_plain(planes, basis, wv, cf, b, p, mcf, mb, mp, *, iters: int,
                   norm: float, inv_m: float, inv_d: float, scale: float,
                   lr_eff: float, alpha: float, mxu_bf16: bool = False):
    """Plain version of :func:`itergrid` (``_itergrid_kernel``): iteration
    0 is the gradient pass on O₀ (its MSE is ``mse[0]``), each later one
    the inertia update, the forward and the next gradients.  Returns
    ``(cf, b, p, mcf, mb, mp, mse [iters+1])``, the MSE sums raw."""
    mses = []
    for i in range(iters + 1):
        if i:
            cf, mcf = burst_inertia(cf, g, mcf, lr_eff, alpha)
            b, mb = burst_inertia(b, db, mb, lr_eff, alpha)
            p, mp = burst_inertia(p, dp, mp, lr_eff, alpha)
        _, mse, g, db, dp = _fused(planes, basis, wv, cf, b, p, norm, inv_m,
                                   inv_d, scale, mxu_bf16, given_o=i == 0,
                                   weighted_e=True)
        mses.append(mse)
    return cf, b, p, mcf, mb, mp, torch.stack(mses)


# ----------------------------------------------------------- wrappers

def _on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device
    raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")


def _check(name: str, planes, basis, wv, cf, b, p=None, kinds=(4, 6)):
    """Shapes, dtypes and devices the kernels take; raises otherwise."""
    ts = [planes, basis, wv, cf, b] + ([] if p is None else [p])
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{name}: every operand must be float32, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.device != planes.device for t in ts):
        raise ValueError(f"{name}: operands on {[str(t.device) for t in ts]}")
    M = b.shape[0] if b.dim() == 1 else 0
    rows, P = cf.shape if cf.dim() == 2 else (0, 0)
    D = rows // (2 * M) if M else 0
    W = planes.shape[-1]
    ok = (planes.dim() == 3 and planes.shape[0] in kinds and D
          and rows == 2 * M * D and planes.shape[1] % D == 0
          and tuple(basis.shape) == (2, P, W) and tuple(wv.shape) == (W,)
          and (p is None or tuple(p.shape) == (D,)))
    if not ok:
        raise ValueError(
            f"{name}: planes {tuple(planes.shape)}, basis "
            f"{tuple(basis.shape)}, wv {tuple(wv.shape)}, cf "
            f"{tuple(cf.shape)}, b {tuple(b.shape)}"
            + ("" if p is None else f", p {tuple(p.shape)}")
            + " do not form [k, nb·D, W], [2, P, W], [W], [2·M·D, P], [M], "
            "[D]")
    if planes.device.type == "cuda" and (D > _MAX_D or P > _MAX_P
                                         or rows > _MAX_ROWS):
        raise ValueError(f"{name}: the kernel takes D <= {_MAX_D}, P <= "
                         f"{_MAX_P} and 2·M·D <= {_MAX_ROWS}; got D={D}, "
                         f"P={P}, M={M}")


def _scratch(kind: int, nb, M, D, P, W, device) -> torch.Tensor:
    n = _kernels.lib().omega_scratch_floats(kind, nb, M, D, P, W)
    if n <= 0:
        raise ValueError("omega_burst: the shape does not fit the kernels")
    return torch.empty(n, dtype=torch.float32, device=device)


#: by (card, stream), the tickets of K5's, K6's and K7's fixed-order sum:
#: zeros, which every launch leaves zero.  Launches on one stream run in
#: order, so each finds them zero; launches on two streams may overlap, so
#: each stream has its own.
_TICKETS: dict = {}


def _tickets(W: int, device) -> torch.Tensor:
    tiles = -(-W // TC_TILE)
    n = -(-tiles // TC_GROUP) + 1     # one a group, one for the groups
    key = (device, _kernels.stream(device))
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        with torch.inference_mode(False):
            t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                            device=device)
    return t


#: K5-K8's basis tiles by (basis tensor, ``mxu_bf16``), oldest
#: first: each entry holds its basis (so the key's ``id`` stays its own),
#: the basis's version counter when laid out, and the tiles.  The engines'
#: bases are cached (``train/fft_pallas._basis``), so a burst lays its tiles
#: out once.  At float32 operands the five bf16 pieces take 3.2x the
#: float32 basis (336 MB at 1024² frames).
_TILE_CACHE: dict = {}
_TILE_CACHE_SIZE = 4


def _version(t: torch.Tensor):
    try:
        return t._version
    except RuntimeError:     # an inference tensor keeps no version counter
        return None


def _tiles(basis: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The basis tiles a launch reads: :func:`basis_tiles` of ``basis``,
    laid out again only when ``basis`` is a tensor not seen lately or was
    changed in place since."""
    key = (id(basis), bool(bf16))
    hit = _TILE_CACHE.pop(key, None)
    if hit is None or hit[1] != _version(basis):
        hit = (basis, _version(basis), basis_tiles(basis, bf16))
    _TILE_CACHE[key] = hit
    while len(_TILE_CACHE) > _TILE_CACHE_SIZE:
        del _TILE_CACHE[next(iter(_TILE_CACHE))]
    return hit[2]


def _ptrs(tensors) -> list:
    return [t.data_ptr() for t in tensors]


def _o_out(out, planes, nb, D, W):
    if out is None:
        return torch.empty((2, nb * D, W), dtype=torch.float32,
                           device=planes.device)
    if tuple(out.shape) != (2, nb * D, W) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous [2, {nb * D}, {W}] "
                         f"tensor, got {tuple(out.shape)}")
    return out


@_kernels.opaque
def grad_project(planes, basis, wv, cf, b, *, norm: float, scale: float,
                 mxu_bf16: bool = False):
    """Projected gradients of one burst iteration from O (K5).

    ``planes [6, nb·D, W]`` (X, Y, O re/im); returns ``g [2·M·D, P]``
    (c's rows, then f's), ``db [M]`` and ``dp [D]``, each summed over the
    frames and scaled by ``scale`` (``1/(2·M·D·N²·nb)``), db and dp also by
    ``norm`` (N = nx·ny).  The kernel reads ``basis`` as its bf16 tiles
    (:func:`basis_tiles`, laid out once per basis tensor).  CPU tensors
    take :func:`grad_project_plain`.
    """
    _check("grad_project", planes, basis, wv, cf, b, kinds=(6,))
    if not _on_card(planes, "grad_project"):
        return grad_project_plain(planes, basis, wv, cf, b, norm=norm,
                                  scale=scale, mxu_bf16=mxu_bf16)
    nb, M, D, W = _dims(planes, cf, b)
    rows, P = cf.shape
    dev = planes.device
    # every buffer stays referenced until the launch is enqueued
    ins = [t.contiguous() for t in (planes, _tiles(basis, mxu_bf16),
                                    wv, cf, b)]
    out = torch.empty(rows * P + 1, dtype=torch.float32, device=dev)
    dbdp = torch.empty(M + D, dtype=torch.float32, device=dev)
    scratch = _scratch(0, nb, M, D, P, W, dev)
    _kernels.launch(
        "omega_grad_project_launch", "grad_project", dev, *_ptrs(ins),
        out.data_ptr(), dbdp.data_ptr(), scratch.data_ptr(),
        _tickets(W, dev).data_ptr(), nb, M, D, P, W, float(norm),
        float(scale), int(mxu_bf16))
    return out[:rows * P].view(rows, P), dbdp[:M], dbdp[M:]


@_kernels.opaque
def respectra_conv(planes, basis, wv, cf, b, p, *, norm: float, inv_m: float,
                   inv_d: float, mxu_bf16: bool = False, out=None):
    """The two-stage conv of an updated kernel pair and its MSE (K6).

    Reads X, Y from ``planes[:4]``; returns ``O [2, nb·D, W]`` (written
    into ``out`` when given) and ``Σ_bins w·|O − Y|² / nb`` (a 0-d tensor).
    The kernel reads the rebuild's part of the basis tiles K5 reads
    (:func:`basis_tiles`, laid out once per basis tensor) and sums its
    tiles' MSE terms in a fixed order inside its one grid.  CPU tensors
    take :func:`respectra_conv_plain`.
    """
    _check("respectra_conv", planes, basis, wv, cf, b, p)
    nb, M, D, W = _dims(planes, cf, b)
    O = _o_out(out, planes, nb, D, W)
    if not _on_card(planes, "respectra_conv"):
        got, mse = respectra_conv_plain(planes, basis, wv, cf, b, p,
                                        norm=norm, inv_m=inv_m, inv_d=inv_d,
                                        mxu_bf16=mxu_bf16)
        return O.copy_(got), mse
    P = cf.shape[1]
    dev = planes.device
    ins = [t.contiguous() for t in (planes, _tiles(basis, mxu_bf16),
                                    wv, cf, b, p)]
    mse = torch.empty(1, dtype=torch.float32, device=dev)
    scratch = _scratch(1, nb, M, D, P, W, dev)
    _kernels.launch(
        "omega_respectra_launch", "respectra_conv", dev, *_ptrs(ins),
        O.data_ptr(), mse.data_ptr(), scratch.data_ptr(),
        _tickets(W, dev).data_ptr(), nb, M, D, P, W, float(norm),
        float(inv_m), float(inv_d), int(mxu_bf16))
    return O, mse[0]


@_kernels.opaque
def fused_step(planes, basis, wv, cf, b, p, *, norm: float, inv_m: float,
               inv_d: float, scale: float, mxu_bf16: bool = False, out=None):
    """K6 and then K5 on the fresh O, in one sweep (K7).

    Returns O (into ``out`` when given), the MSE sum, g, db, dp, as
    :func:`respectra_conv` and :func:`grad_project` do, and reads the
    basis as :func:`grad_project` does.  CPU tensors take
    :func:`fused_step_plain`.
    """
    _check("fused_step", planes, basis, wv, cf, b, p)
    nb, M, D, W = _dims(planes, cf, b)
    O = _o_out(out, planes, nb, D, W)
    if not _on_card(planes, "fused_step"):
        got, mse, g, db, dp = fused_step_plain(
            planes, basis, wv, cf, b, p, norm=norm, inv_m=inv_m, inv_d=inv_d,
            scale=scale, mxu_bf16=mxu_bf16)
        return O.copy_(got), mse, g, db, dp
    rows, P = cf.shape
    dev = planes.device
    ins = [t.contiguous() for t in (planes, _tiles(basis, mxu_bf16),
                                    wv, cf, b, p)]
    res = torch.empty(rows * P + 1, dtype=torch.float32, device=dev)
    dbdp = torch.empty(M + D, dtype=torch.float32, device=dev)
    scratch = _scratch(0, nb, M, D, P, W, dev)
    _kernels.launch(
        "omega_fused_step_launch", "fused_step", dev, *_ptrs(ins),
        O.data_ptr(), res.data_ptr(), dbdp.data_ptr(), scratch.data_ptr(),
        _tickets(W, dev).data_ptr(), nb, M, D, P, W, float(norm),
        float(inv_m), float(inv_d), float(scale), int(mxu_bf16))
    return (O, res[rows * P], res[:rows * P].view(rows, P), dbdp[:M],
            dbdp[M:])


@_kernels.opaque
def itergrid(planes, basis, wv, cf, b, p, mcf, mb, mp, *, iters: int,
             norm: float, inv_m: float, inv_d: float, scale: float,
             lr_eff: float, alpha: float, mxu_bf16: bool = False):
    """The whole burst in one launch (K8): ``iters`` inertia updates, each
    from the gradients of the previous sweep, starting from those on O₀.

    ``planes [6, nb·D, W]`` (X, Y, O₀); ``cf, b, p`` the weights and
    ``mcf, mb, mp`` their momenta.  Returns ``(cf, b, p, mcf, mb, mp, mse
    [iters+1])``, the MSE sums raw (``Σ w|O − Y|² / nb`` per iteration).
    The kernel reads the basis tiles K5 and K7 read (:func:`basis_tiles`),
    every block resident (as many as fit, at most one a tile), and sums
    each iteration's tile partials in a fixed order between grid barriers.
    CPU tensors take :func:`itergrid_plain`; a card without cooperative
    launch raises.
    """
    _check("itergrid", planes, basis, wv, cf, b, p, kinds=(6,))
    if not _on_card(planes, "itergrid"):
        return itergrid_plain(planes, basis, wv, cf, b, p, mcf, mb, mp,
                              iters=iters, norm=norm, inv_m=inv_m,
                              inv_d=inv_d, scale=scale, lr_eff=lr_eff,
                              alpha=alpha, mxu_bf16=mxu_bf16)
    nb, M, D, W = _dims(planes, cf, b)
    rows, P = cf.shape
    n = rows * P
    dev = planes.device
    state = torch.cat([t.reshape(-1) for t in (cf, b, p, mcf, mb, mp)])
    if state.dtype != torch.float32 or state.numel() != 2 * (n + M + D):
        raise ValueError("itergrid: the momenta must match the weights")
    ins = [t.contiguous() for t in (planes, _tiles(basis, mxu_bf16), wv)]
    new = torch.empty_like(state)
    mse = torch.empty(iters + 1, dtype=torch.float32, device=dev)
    scratch = _scratch(2, nb, M, D, P, W, dev)
    _kernels.launch(
        "omega_itergrid_launch", "itergrid", dev, *_ptrs(ins),
        state.data_ptr(), new.data_ptr(), mse.data_ptr(), scratch.data_ptr(),
        nb, M, D, P, W, int(iters), float(norm), float(inv_m), float(inv_d),
        float(scale), float(lr_eff), float(alpha), int(mxu_bf16))
    parts = torch.split(new, [n, M, D, n, M, D])
    return (parts[0].view(rows, P), parts[1], parts[2],
            parts[3].view(rows, P), parts[4], parts[5], mse)
