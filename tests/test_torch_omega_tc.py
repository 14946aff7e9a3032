"""K5-K8 on the tensor cores, on the CPU: the host layout of their basis
tiles and their order of products, against the plain versions.

The kernels (``csrc/omega_burst.cu`` ``tc_sweep_kernel``,
``tc_itergrid_kernel``) cannot run here, so this file checks what
surrounds them:

- :func:`burst_kernels.basis_tiles`, read back through a CPU copy of the
  kernel's addressing (``off32`` for the rebuild's copy, ``wg::tile_off``
  for the projection's), gives the basis: piece 0 is its bf16 rounding
  and the pieces sum to it within the last piece's rounding; the part of
  a tile record K6 reads is the rebuild's copy;
- the kernels' arithmetic emulated with the same bf16 pieces at the same
  tiers (:data:`burst_kernels.TC_TIERS`), exact float32 products, each
  64-bin tile's projection fresh and the tiles' partials (and MSE terms)
  summed in groups of 16 in tile order, then the groups in order, held
  against :func:`grad_project_plain`, :func:`respectra_conv_plain` (K6's
  forward in conv_k's order), :func:`fused_step_plain` and
  :func:`itergrid_plain` (K8: E weighted once before the products, the
  inertia update between sweeps) at the JAX benchmark's headline width
  (one 256² frame, W = 33,024; K8 two iterations there, three at the
  small shapes) and at small shapes, within the kernels' tolerances on the
  card: 1e-5 norm-relative per output with float32 operands, 2e-3 with
  bf16 ones.  This is the error budget of the chosen tiers: with bf16×3
  for the spectra rebuild O came to 8-9e-6 of the plain version at the
  headline, so the rebuild takes bf16×6 (4e-7) and the projection bf16×3
  (g 2-4e-6).

The products on the card also truncate as they accumulate (~2^-25 a
step, 12 steps a rebuild and 24 a tile's projection), which the emulation
leaves out; the card-only tests hold the kernels themselves.
"""

import pytest
import torch

from spectralae_torch.ops import burst_kernels as bk
from spectralae_torch.ops import fft_kernels as fk
from spectralae_torch.optim.update import burst_inertia
from spectralae_torch.train import fft_pallas as fp

torch.set_num_threads(1)

TOL, TOL_BF16 = 1e-5, 2e-3


def _problem(nb, D, M, nk, n, seed=0):
    """The card tests' problem (tests/test_torch_burst_kernels.py), made
    on the CPU: pixel-scale frames, the output of other weights."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=1.0):
        return torch.randn(*shape, generator=gen) * s
    x = torch.rand(nb, D, n, n, generator=gen) * 255
    c, f = rnd(M, D, nk, nk, s=0.3), rnd(D, M, nk, nk, s=0.3)
    b, p = rnd(M, s=0.5), rnd(D, s=0.5)
    out0 = x * 0.9 + rnd(nb, D, n, n, s=5.0)
    s = fp._prepare(x, x, out0, c, True, torch.float32)
    return s, fp._stack(c, f, M * D, nk * nk), b, p


def _off32(r, k):
    """csrc/omega_burst.cu ``off32``: (row, contraction) in a 32-wide tile."""
    return ((r >> 3) * 4 + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7)


def _off64(r, k):
    """csrc/wgmma.cuh ``tile_off``: the same in a 64-wide tile."""
    return ((r >> 3) * 8 + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7)


def _read_back(tiles, bf16, P, W):
    """The two copies' pieces ``[pieces, 2, P, W]`` as the kernel reads
    them: tile t, chunk c of 32 taps, piece i, cos|sin cs, (bin u, tap
    32·c + p) at ``off32(u, p)`` of the rebuild's copy and at
    ``_off64(p, u)`` of the projection's, each copy's chunks in order."""
    T, n = bk.TC_TILE, 32 * bk.TC_TILE
    np_r, np_p = (fk._TIERS[q] + 1 for q in bk.TC_TIERS[bf16])
    nt, nc = tiles.shape[0], -(-P // 32)
    u = torch.arange(T)[:, None]
    p = torch.arange(32)[None, :]
    rcopy = tiles[:, :nc * np_r * 2 * n].reshape(nt, nc, np_r, 2, n)
    pcopy = tiles[:, nc * np_r * 2 * n:].reshape(nt, nc, np_p, 2, n)
    r = rcopy[..., _off32(u, p)]                    # [t, c, i, cs, u, p]
    q = pcopy[..., _off64(p, u)]
    out = []
    for c in (r, q):
        c = c.float().permute(2, 3, 1, 5, 0, 4).reshape(c.shape[2], 2,
                                                        nc * 32, nt * T)
        assert not c[:, :, P:].any() and not c[..., W:].any()   # the padding
        out.append(c[:, :, :P, :W])
    return out


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("P,W", [(25, 2112), (9, 220), (25, 33024),
                                 (49, 2112), (169, 544)])
def test_basis_tiles_read_back_to_the_basis(bf16, P, W):
    gen = torch.Generator().manual_seed(P + W)
    basis = torch.rand(2, P, W, generator=gen) * 2 - 1
    tiles = bk.basis_tiles(basis, bf16)
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
    assert tiles.shape[0] == -(-W // bk.TC_TILE)
    n_r, n_p = (fk._TIERS[q] + 1 for q in bk.TC_TIERS[bf16])
    assert tiles.shape[1] == -(-P // 32) * (n_r + n_p) * 2 * 32 * bk.TC_TILE
    for pieces, prec in zip(_read_back(tiles, bf16, P, W), bk.TC_TIERS[bf16]):
        n = fk._TIERS[prec] + 1
        assert pieces.shape[0] == n
        assert torch.equal(pieces[0], basis.to(torch.bfloat16).float())
        # each piece is the rounding of what the earlier ones left
        assert torch.equal(pieces, torch.stack(fk.pieces(basis, n)))
        left = (basis - pieces.sum(0)).abs()
        assert float(left.max()) <= 2.0 ** (-8 * n - 1) * 2


def _in_order(part):
    """``part [tiles, ...]`` summed as the kernels sum it: groups of
    :data:`TC_GROUP` tiles in tile order, then the groups in order."""
    G = bk.TC_GROUP
    ng = -(-part.shape[0] // G)
    z = part.new_zeros((ng * G,) + part.shape[1:])
    z[:part.shape[0]] = part
    z = z.reshape((ng, G) + part.shape[1:])
    group = z[:, 0]
    for i in range(1, G):
        group = group + z[:, i]
    out = group[0]
    for k in range(1, ng):
        out = out + group[k]
    return out


def _sweep(planes, basis, wv, cf, b, p, consts, bf16, mode):
    """One launch of the tensor-core sweep (one K8 iteration) as the kernel
    computes it: the spectra from the bf16 pieces at the rebuild's tier,
    the per-bin pass in float32 (K6: X times 1/M first, the bias, then
    1/D; K8: E weighted by wv once, before the products), each 64-bin
    tile's MSE term, then per tile the projection of ``d_re·wv`` against
    cos plus that of ``−d_im·wv`` against sin (K8: the products carry wv
    already; one warpgroup each) at the projection's tier, the tiles'
    records summed by :func:`_in_order`, g times ``scale`` at the end.
    Returns O (K6, K7), the MSE sum, g, db, dp (not K6's)."""
    rt, pt = bk.TC_TIERS[bf16]
    nb, M, D, W = bk._dims(planes, cf, b)
    norm, inv_m, inv_d = consts["norm"], consts["inv_m"], consts["inv_d"]
    allr = fk.split_dot(cf, basis[0], rt)
    alli = -fk.split_dot(cf, basis[1], rt)
    cfr, cfi, ffr, ffi = bk._split_spectra(allr, alli, M, D, W)
    xr, xi, yr, yi = bk._frames(planes[:4], nb, D, W)
    T = bk.TC_TILE
    nt = -(-W // T)

    def tiled(a):              # [r, W] -> [nt, r, T], zeros past W
        z = a.new_zeros(a.shape[0], nt * T)
        z[:, :W] = a
        return z.reshape(a.shape[0], nt, T).permute(1, 0, 2)
    if mode == "k6":
        hr, hi = bk._contract_h(cfr, cfi, xr * inv_m, xi * inv_m)
        hr[..., 0] += b * norm
        our, oui = bk._conv_out(ffr, ffi, hr * inv_d, hi * inv_d, p, norm)
    else:
        h0r, h0i = bk._contract_h(cfr, cfi, xr, xi)
        bias = torch.zeros_like(h0r)
        bias[..., 0] = b * norm
        if mode in ("k7", "k8"):
            our, oui = bk._conv_out(ffr, ffi, (h0r * inv_m + bias) * inv_d,
                                    h0i * inv_m * inv_d, p, norm)
        else:
            our, oui = bk._frames(planes[4:6], nb, D, W)
    er, ei = our - yr, oui - yi
    weighted = mode.startswith("k8")
    if weighted:
        erw, eiw = er * wv, ei * wv
        terms = er * erw + ei * eiw
        er, ei = erw, eiw
    else:
        terms = (er ** 2 + ei ** 2) * wv
    mse = _in_order(tiled(terms.sum((0, 1))[None]).sum((1, 2)) / nb)
    O = torch.stack([our.reshape(nb * D, W), oui.reshape(nb * D, W)])
    if mode == "k6":
        return O, mse, None, None, None
    d_re, d_im, sr = bk._grad_products(er, ei, xr, xi, h0r + bias, h0i, ffr,
                                       ffi, None if weighted else wv)
    part = (fk.split_dot(tiled(d_re), tiled(basis[0]).transpose(-1, -2), pt)
            + fk.split_dot(tiled(-d_im), tiled(basis[1]).transpose(-1, -2),
                           pt))
    db, dp = bk._bias_grads(sr, er, norm, consts["scale"])
    return O, mse, _in_order(part) * consts["scale"], db, dp


def _itergrid(planes, basis, wv, cf, b, p, mcf, mb, mp, consts, bf16,
              iters, lr_eff, alpha):
    """K8's burst as the kernel computes it: :func:`_sweep` at iteration 0
    on O₀, then per iteration the inertia update and the sweep with the
    forward.  Returns what :func:`itergrid_plain` returns."""
    mses = []
    for i in range(iters + 1):
        if i:
            cf, mcf = burst_inertia(cf, g, mcf, lr_eff, alpha)
            b, mb = burst_inertia(b, db, mb, lr_eff, alpha)
            p, mp = burst_inertia(p, dp, mp, lr_eff, alpha)
        _, mse, g, db, dp = _sweep(planes, basis, wv, cf, b, p, consts, bf16,
                                   "k8" if i else "k8_0")
        mses.append(mse)
    return cf, b, p, mcf, mb, mp, torch.stack(mses)


def _rel(got, want) -> float:
    got, want = got.double().reshape(-1), want.double().reshape(-1)
    return float((got - want).norm() / want.norm())


SHAPES = {  # (nb, D, M, nk, n)
    "headline 256x256 b1, W=33024": (1, 3, 10, 5, 256),
    "64x64 b1, W=2112": (1, 3, 10, 5, 64),
    "40x40 b4, W=840": (4, 3, 10, 5, 40),
    "20x20 b3 D=2 M=4 3x3, W=220": (3, 2, 4, 3, 20),
    # 13x13 kernels: 169 taps, six chunks of 32 (the 13x13 fused burst)
    "32x32 b1 13x13, W=544": (1, 3, 10, 13, 32),
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tensor_core_order_matches_the_plain_versions(shape, bf16):
    s, cf, b, p = _problem(*SHAPES[shape])
    k = s.consts
    tol = TOL_BF16 if bf16 else TOL
    want7 = bk.fused_step_plain(s.planes, s.basis, s.wv, cf, b, p,
                                mxu_bf16=bf16, **k)
    got7 = _sweep(s.planes, s.basis, s.wv, cf, b, p, k, bf16, "k7")
    for name, g, w in zip(("O", "mse", "g", "db", "dp"), got7, want7):
        assert _rel(g, w) < tol, f"K7 {name}: {_rel(g, w):.3e}"
    want5 = bk.grad_project_plain(s.planes, s.basis, s.wv, cf, b,
                                  norm=k["norm"], scale=k["scale"],
                                  mxu_bf16=bf16)
    got5 = _sweep(s.planes, s.basis, s.wv, cf, b, p, k, bf16, "k5")[2:]
    for name, g, w in zip(("g", "db", "dp"), got5, want5):
        assert _rel(g, w) < tol, f"K5 {name}: {_rel(g, w):.3e}"


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_k6_order_matches_the_plain_version(shape, bf16):
    """K6 as K7's forward half: conv_k's order (X times 1/M first), the
    rebuild at K7's tier, the tiles' MSE terms in the fixed order."""
    s, cf, b, p = _problem(*SHAPES[shape])
    k = {n: s.consts[n] for n in ("norm", "inv_m", "inv_d")}
    want = bk.respectra_conv_plain(s.planes, s.basis, s.wv, cf, b, p,
                                   mxu_bf16=bf16, **k)
    got = _sweep(s.planes, s.basis, s.wv, cf, b, p, s.consts, bf16, "k6")
    tol = TOL_BF16 if bf16 else TOL
    for name, g, w in zip(("O", "mse"), got, want):
        assert _rel(g, w) < tol, f"K6 {name}: {_rel(g, w):.3e}"


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_k8_order_matches_the_plain_version(shape, bf16):
    """K8's burst: E weighted once, each iteration's sweep on the tensor
    cores' order, the inertia update between (two iterations at the
    headline, three elsewhere)."""
    s, cf, b, p = _problem(*SHAPES[shape])
    gen = torch.Generator().manual_seed(11)
    mom = [torch.randn(t.shape, generator=gen) * 0.01 for t in (cf, b, p)]
    iters = 2 if shape.startswith("headline") else 3
    hyper = dict(iters=iters, lr_eff=0.02, alpha=0.9)
    want = bk.itergrid_plain(s.planes, s.basis, s.wv, cf, b, p, *mom,
                             mxu_bf16=bf16, **hyper, **s.consts)
    got = _itergrid(s.planes, s.basis, s.wv, cf, b, p, *mom, s.consts, bf16,
                    **hyper)
    assert got[-1].shape == (iters + 1,)
    tol = TOL_BF16 if bf16 else TOL
    for name, g, w in zip(("cf", "b", "p", "mcf", "mb", "mp", "mses"), got,
                          want):
        assert _rel(g, w) < tol, f"K8 {name}: {_rel(g, w):.3e}"


@pytest.mark.parametrize("bf16", [False, True])
def test_k6_reads_the_rebuild_part_of_the_tiles(bf16):
    """A tile record is the rebuild's copy, then the projection's
    (csrc/omega_burst.cu ``tc_tile_elems``); K6 reads the first part only,
    which reads back to the rebuild tier's pieces of the basis whatever the
    projection's tier, so B7's K5 and K6 share one layout."""
    P, W = 25, 2112
    gen = torch.Generator().manual_seed(5)
    basis = torch.rand(2, P, W, generator=gen) * 2 - 1
    tiles = bk.basis_tiles(basis, bf16)
    n, n_proj = (fk._TIERS[q] + 1 for q in bk.TC_TIERS[bf16])
    rebuild = n * 2 * 32 * bk.TC_TILE
    assert tiles.shape == (-(-W // bk.TC_TILE),
                           rebuild + n_proj * 2 * 32 * bk.TC_TILE)
    prec = bk.TC_TIERS[bf16][0]
    head = tiles[:, :rebuild]
    # the record's head alone reads back to the rebuild's pieces
    r = head.reshape(-1, n, 2, 32 * bk.TC_TILE)[
        ..., _off32(torch.arange(bk.TC_TILE)[:, None],
                    torch.arange(32)[None, :])]            # [t, i, cs, u, p]
    r = r.float().permute(1, 2, 4, 0, 3).reshape(n, 2, 32, -1)[:, :, :P, :W]
    assert torch.equal(r, torch.stack(fk.pieces(basis, n)))
    # and does not depend on the projection's tier
    tiers = dict(bk.TC_TIERS)
    try:
        bk.TC_TIERS[bf16] = (prec, "default" if prec != "default" else "high")
        assert torch.equal(bk.basis_tiles(basis, bf16)[:, :rebuild], head)
    finally:
        bk.TC_TIERS.update(tiers)


def test_three_products_would_miss_the_rebuild_budget():
    """Why the float32 rebuild takes bf16×6: at bf16×3 the headline's O
    takes more than half its 1e-5 tolerance (8-9e-6) before any rounding
    of the card's own; bf16×6 leaves it 20 times inside."""
    s, cf, b, p = _problem(*SHAPES["headline 256x256 b1, W=33024"])
    O = bk.fused_step_plain(s.planes, s.basis, s.wv, cf, b, p,
                            **s.consts)[0]
    errs = {}
    for prec in ("high", "highest"):
        tiers = dict(bk.TC_TIERS)
        bk.TC_TIERS[False] = (prec, "high")
        try:
            errs[prec] = _rel(_sweep(s.planes, s.basis, s.wv, cf, b, p,
                                     s.consts, False, "k7")[0], O)
        finally:
            bk.TC_TIERS.update(tiers)
    assert errs["high"] > TOL / 2 and errs["highest"] < TOL / 20


def test_tiles_are_checked_and_built_on_demand():
    """A launch's tiles are laid out once per basis tensor and operand
    type, and again when the basis changes in place."""
    s, cf, b, p = _problem(1, 3, 10, 5, 16)
    built = bk._tiles(s.basis, False)
    assert torch.equal(built, bk.basis_tiles(s.basis, False))
    assert bk._tiles(s.basis, False) is built
    # the engines' basis is one cached tensor, so a burst reuses its tiles
    again = _problem(1, 3, 10, 5, 16, seed=1)[0]
    assert again.basis is s.basis and bk._tiles(again.basis, False) is built
    other = bk._tiles(s.basis, True)     # the other tiers' pieces
    assert torch.equal(other, bk.basis_tiles(s.basis, True))
    basis = s.basis.clone()
    first = bk._tiles(basis, False)
    assert first is not built and torch.equal(first, built)
    basis[0, 0, 0] += 1.0
    assert torch.equal(bk._tiles(basis, False),
                       bk.basis_tiles(basis, False))
    for _ in range(bk._TILE_CACHE_SIZE + 1):     # the cache stays bounded
        bk._tiles(s.basis.clone(), False)
    assert len(bk._TILE_CACHE) == bk._TILE_CACHE_SIZE

