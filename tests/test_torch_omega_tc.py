"""K5 and K7 on the tensor cores, on the CPU: the host layout of their basis
tiles and their order of products, against the plain versions.

The kernels (``csrc/omega_burst.cu`` ``tc_sweep_kernel``) cannot run here,
so this file checks what surrounds them:

- :func:`burst_kernels.basis_tiles`, read back through a CPU copy of the
  kernel's addressing (``off32`` for the rebuild's copy, ``wg::tile_off``
  for the projection's), gives the basis: piece 0 is its bf16 rounding
  and the pieces sum to it within the last piece's rounding;
- the kernel's arithmetic emulated with the same bf16 pieces at the same
  tiers (:data:`burst_kernels.TC_TIERS`), exact float32 products, each
  64-bin tile's projection fresh and the tiles' partials summed in groups
  of 16 in tile order, then the groups in order, held against
  :func:`grad_project_plain` and :func:`fused_step_plain` at the JAX
  benchmark's headline width (one 256² frame, W = 33,024) and at small
  shapes, within the kernels' tolerances on the card: 1e-5 norm-relative
  per output with float32 operands, 2e-3 with bf16 ones.  This is the
  error budget of the chosen tiers: with bf16×3 for the spectra rebuild O
  came to 8-9e-6 of the plain version at the headline, so the rebuild
  takes bf16×6 (4e-7) and the projection bf16×3 (g 2-4e-6).

The products on the card also truncate as they accumulate (~2^-25 a
step, 12 steps a rebuild and 24 a tile's projection), which the emulation
leaves out; the card-only tests hold the kernels themselves.
"""

import pytest
import torch

from spectralae_torch.ops import burst_kernels as bk
from spectralae_torch.ops import fft_kernels as fk
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
    them: tile t, piece i, cos|sin cs, (bin u, p) at ``off32(u, p)`` of the
    rebuild's copy and at ``_off64(p, u)`` of the projection's."""
    T, n = bk.TC_TILE, 32 * bk.TC_TILE
    np_r, np_p = (fk._TIERS[q] + 1 for q in bk.TC_TIERS[bf16])
    nt = tiles.shape[0]
    u = torch.arange(T)[:, None]
    p = torch.arange(32)[None, :]
    rcopy = tiles[:, :np_r * 2 * n].reshape(nt, np_r, 2, n)
    pcopy = tiles[:, np_r * 2 * n:].reshape(nt, np_p, 2, n)
    r = rcopy[..., _off32(u, p)]                    # [t, i, cs, u, p]
    q = pcopy[..., _off64(p, u)]
    out = []
    for c in (r, q):
        c = c.float().permute(1, 2, 4, 0, 3).reshape(c.shape[1], 2, 32,
                                                     nt * T)
        assert not c[:, :, P:].any() and not c[..., W:].any()   # the padding
        out.append(c[:, :, :P, :W])
    return out


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("P,W", [(25, 2112), (9, 220), (25, 33024)])
def test_basis_tiles_read_back_to_the_basis(bf16, P, W):
    gen = torch.Generator().manual_seed(P + W)
    basis = torch.rand(2, P, W, generator=gen) * 2 - 1
    tiles = bk.basis_tiles(basis, bf16)
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
    assert tiles.shape[0] == -(-W // bk.TC_TILE)
    for pieces, prec in zip(_read_back(tiles, bf16, P, W), bk.TC_TIERS[bf16]):
        n = fk._TIERS[prec] + 1
        assert pieces.shape[0] == n
        assert torch.equal(pieces[0], basis.to(torch.bfloat16).float())
        # each piece is the rounding of what the earlier ones left
        assert torch.equal(pieces, torch.stack(fk.pieces(basis, n)))
        left = (basis - pieces.sum(0)).abs()
        assert float(left.max()) <= 2.0 ** (-8 * n - 1) * 2


def _emulate(planes, basis, wv, cf, b, p, consts, bf16, fused):
    """K7 (``fused``) or K5 as the tensor-core sweep computes it: the
    spectra from the bf16 pieces at the rebuild's tier, the per-bin pass in
    float32, then per 64-bin tile the projection of ``d_re·wv`` against cos
    plus that of ``−d_im·wv`` against sin (one warpgroup each) at the
    projection's tier, the tiles' partials summed in groups of
    :data:`TC_GROUP` in tile order and the groups in order, times
    ``scale`` at the end.  Returns O (K7), the MSE sum, g, db, dp."""
    rt, pt = bk.TC_TIERS[bf16]
    nb, M, D, W = bk._dims(planes, cf, b)
    allr = fk.split_dot(cf, basis[0], rt)
    alli = -fk.split_dot(cf, basis[1], rt)
    cfr, cfi, ffr, ffi = bk._split_spectra(allr, alli, M, D, W)
    xr, xi, yr, yi = bk._frames(planes[:4], nb, D, W)
    h0r, h0i = bk._contract_h(cfr, cfi, xr, xi)
    bias = torch.zeros_like(h0r)
    bias[..., 0] = b * consts["norm"]
    if fused:
        our, oui = bk._conv_out(ffr, ffi,
                                (h0r * consts["inv_m"] + bias)
                                * consts["inv_d"],
                                h0i * consts["inv_m"] * consts["inv_d"], p,
                                consts["norm"])
    else:
        our, oui = bk._frames(planes[4:6], nb, D, W)
    er, ei = our - yr, oui - yi
    mse = torch.sum((er ** 2 + ei ** 2) * wv) / nb
    d_re, d_im, sr = bk._grad_products(er, ei, xr, xi, h0r + bias, h0i, ffr,
                                       ffi, wv)
    T, G = bk.TC_TILE, bk.TC_GROUP
    ng = -(-(-(-W // T)) // G)

    def tiled(a):              # [r, W] -> [ng·G, r, T], zeros past W
        z = a.new_zeros(a.shape[0], ng * G * T)
        z[:, :W] = a
        return z.reshape(a.shape[0], ng * G, T).permute(1, 0, 2)
    part = (fk.split_dot(tiled(d_re), tiled(basis[0]).transpose(-1, -2), pt)
            + fk.split_dot(tiled(-d_im), tiled(basis[1]).transpose(-1, -2),
                           pt)).reshape(ng, G, -1, basis.shape[1])
    group = part[:, 0]
    for i in range(1, G):
        group = group + part[:, i]
    g = group[0]
    for k in range(1, ng):
        g = g + group[k]
    db, dp = bk._bias_grads(sr, er, consts["norm"], consts["scale"])
    O = torch.stack([our.reshape(nb * D, W), oui.reshape(nb * D, W)])
    return O, mse, g * consts["scale"], db, dp


def _rel(got, want) -> float:
    got, want = got.double().reshape(-1), want.double().reshape(-1)
    return float((got - want).norm() / want.norm())


SHAPES = {  # (nb, D, M, nk, n)
    "headline 256x256 b1, W=33024": (1, 3, 10, 5, 256),
    "64x64 b1, W=2112": (1, 3, 10, 5, 64),
    "40x40 b4, W=840": (4, 3, 10, 5, 40),
    "20x20 b3 D=2 M=4 3x3, W=220": (3, 2, 4, 3, 20),
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tensor_core_order_matches_the_plain_versions(shape, bf16):
    s, cf, b, p = _problem(*SHAPES[shape])
    k = s.consts
    tol = TOL_BF16 if bf16 else TOL
    want7 = bk.fused_step_plain(s.planes, s.basis, s.wv, cf, b, p,
                                mxu_bf16=bf16, **k)
    got7 = _emulate(s.planes, s.basis, s.wv, cf, b, p, k, bf16, True)
    for name, g, w in zip(("O", "mse", "g", "db", "dp"), got7, want7):
        assert _rel(g, w) < tol, f"K7 {name}: {_rel(g, w):.3e}"
    want5 = bk.grad_project_plain(s.planes, s.basis, s.wv, cf, b,
                                  norm=k["norm"], scale=k["scale"],
                                  mxu_bf16=bf16)
    got5 = _emulate(s.planes, s.basis, s.wv, cf, b, p, k, bf16, False)[2:]
    for name, g, w in zip(("g", "db", "dp"), got5, want5):
        assert _rel(g, w) < tol, f"K5 {name}: {_rel(g, w):.3e}"


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
            errs[prec] = _rel(_emulate(s.planes, s.basis, s.wv, cf, b, p,
                                       s.consts, False, True)[0], O)
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

