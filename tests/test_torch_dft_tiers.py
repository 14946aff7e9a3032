"""The JAX precision tiers of the port's matmul-DFT kernels, on the CPU.

On the card the four-step FFT's leaves (B5a, B5b, B5e) and the fused
y-DFT probe (P2) multiply bf16 pieces on the tensor cores: ``"default"``
one bf16 product, ``"high"`` the bf16×3 split of the JAX package's
``_dot_fn`` (spectralae/ops/pallas_fft.py:151), ``"highest"`` bf16×6.
Their plain versions take the same ``precision`` and round the same
operands (P after the butterfly and twiddle, never the input; for P2 ``x``
and the bases).  Here, with numpy inputs from a seed:

- the tier-matched plain versions against the JAX package: ``"high"``
  against ``rfft2_mixed(precision=HIGH, interpret=True)``, the same split
  algebra except that on the CPU JAX keeps the residual ``a − hi`` in
  float32 where the tensor cores take ``bf16(a − hi)``: the two differ by
  that rounding, ~2⁻¹⁸ of a product (3.4e-6 norm-relative on random
  products), so 1e-5; and against the same JAX transform with its
  products' operands rounded to bf16 as the TPU's matrix unit and the
  tensor cores take them, the same algebra, within 1e-6; ``"default"`` and
  ``"highest"`` against JAX's ``HIGHEST`` within the tier's bound
  (``fft_kernels.TIER_TOL``);
- the bf16 pieces reconstructing the float32 bases to 2⁻¹⁶ (two pieces)
  and 2⁻²⁴ (three), and the bases' tiles as the kernels read them
  reproducing each tier's plain product (the host layout of
  ``csrc/wgmma.cuh``);
- ``ydft_energy_plain`` per tier against the JAX probe's ``ref_energy``;
- the stream's ``"fft"`` and ``"fft-bf16"`` routes passing ``"high"`` and
  ``"default"`` to ``rfft2_mixed``, as spectralae/train/fft_corr.py:458-462
  does, and ``precision=None`` running at ``"default"`` on the card.

The CPU route of the public wrappers computes float32 for every tier
(tests/test_torch_fft_kernels.py::test_rfft2_precision_tiers).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from spectralae_torch.ops import fft_kernels as fk
from spectralae_torch.ops import probe_kernels as pk

torch.set_num_threads(1)

# each tier against the exact transform: fft_kernels.TIER_TOL
TIERS, TIER_TOL = fk.TIERS, fk.TIER_TOL
# "high" against JAX's interpret-mode HIGH: the residual's bf16 rounding
HIGH_VS_JAX = 1e-5
# ... and against it with bf16 operands in its products: only the order of
# the float32 sums differs
HIGH_VS_JAX_BF16 = 1e-6
# the bases' tiles against the plain products: the same pieces and exact
# products, summed in another order
LAYOUT_TOL = 1e-6


def rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def frames(seed, shape, scale=7.0):
    return (np.random.default_rng(seed).normal(size=shape)
            .astype(np.float32) * scale)


def mixed(planes):
    return (np.asarray(planes[0], np.float32)
            + 1j * np.asarray(planes[1], np.float32))


# -------------------------------------------- the plain versions vs JAX

@pytest.mark.parametrize("nx,ny,max_m1", [(64, 64, 512), (32, 48, 512),
                                          (128, 64, 8)])
def test_plain_high_tier_matches_jax_high(nx, ny, max_m1, monkeypatch):
    """The bf16×3 plain transform against JAX's manual HIGH split in
    interpret mode, on the live lanes, with and without the recursion."""
    import jax
    import jax.numpy as jnp
    from spectralae.ops import pallas_fft as pf
    monkeypatch.setattr(pf, "_MAX_M1", max_m1)
    monkeypatch.setattr(fk, "_MAX_M1", max_m1)
    x = frames(0, (3, nx, ny))
    got = mixed(fk.rfft2_mixed_plain(torch.from_numpy(x), precision="high"))
    want = mixed(pf.rfft2_mixed(jnp.asarray(x),
                                precision=jax.lax.Precision.HIGH,
                                interpret=True))
    live = fk.perm_y(ny) >= 0
    assert rel(got[..., live], want[..., live]) < HIGH_VS_JAX
    nat = fk.to_natural(fk.rfft2_mixed_plain(torch.from_numpy(x),
                                             precision="high"), nx, ny)
    assert rel(nat, np.fft.rfft2(x)) < TIER_TOL["high"]


def _bf16_operand_dot_fn(precision):
    """The JAX package's HIGH split (``pallas_fft._dot_fn``) with each
    product's operands rounded to bf16, as the TPU's matrix unit and the
    tensor cores take them: the residual reaches its products as
    ``bf16(a − hi)``; the sums stay float32, in JAX's order."""
    import jax
    import jax.numpy as jnp
    assert precision == jax.lax.Precision.HIGH

    def bf16(t):
        return t.astype(jnp.bfloat16).astype(jnp.float32)

    def d(a, b):
        return jnp.dot(bf16(a), bf16(b), preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)

    def dot3(a, b):
        ah, bh = bf16(a), bf16(b)
        return d(a - ah, bh) + (d(ah, b - bh) + d(ah, bh))
    return dot3


@pytest.mark.parametrize("nx,ny,max_m1", [(64, 64, 512), (32, 48, 512),
                                          (128, 64, 8)])
def test_plain_high_tier_matches_jax_high_on_bf16_operands(nx, ny, max_m1,
                                                           monkeypatch):
    """The bf16×3 plain transform against JAX's HIGH split with bf16
    operands in its products (interpret mode), on the live lanes, with
    and without the recursion: the same algebra to the float32 sums."""
    import jax
    import jax.numpy as jnp
    from spectralae.ops import pallas_fft as pf
    monkeypatch.setattr(pf, "_MAX_M1", max_m1)
    monkeypatch.setattr(fk, "_MAX_M1", max_m1)
    monkeypatch.setattr(pf, "_dot_fn", _bf16_operand_dot_fn)
    x = frames(0, (3, nx, ny))
    got = mixed(fk.rfft2_mixed_plain(torch.from_numpy(x), precision="high"))
    want = mixed(pf.rfft2_mixed(jnp.asarray(x),
                                precision=jax.lax.Precision.HIGH,
                                interpret=True))
    live = fk.perm_y(ny) >= 0
    assert rel(got[..., live], want[..., live]) < HIGH_VS_JAX_BF16


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("nx,ny,max_m1", [(64, 64, 512), (16, 48, 512),
                                          (64, 128, 8)])
def test_plain_tiers_match_jax_highest(nx, ny, max_m1, precision,
                                       monkeypatch):
    """The bf16 and bf16×6 plain transforms against JAX's HIGHEST (interpret
    mode) and numpy, within the tier's bound, on the live lanes."""
    import jax
    import jax.numpy as jnp
    from spectralae.ops import pallas_fft as pf
    monkeypatch.setattr(pf, "_MAX_M1", max_m1)
    monkeypatch.setattr(fk, "_MAX_M1", max_m1)
    x = frames(1, (2, nx, ny))
    planes = fk.rfft2_mixed_plain(torch.from_numpy(x), precision=precision)
    want = mixed(pf.rfft2_mixed(jnp.asarray(x),
                                precision=jax.lax.Precision.HIGHEST,
                                interpret=True))
    live = fk.perm_y(ny) >= 0
    assert rel(mixed(planes)[..., live], want[..., live]) \
        < TIER_TOL[precision]
    assert rel(fk.to_natural(planes, nx, ny), np.fft.rfft2(x)) \
        < TIER_TOL[precision]


@pytest.mark.parametrize("precision", TIERS)
def test_each_leaf_rounds_p_after_the_twiddle(precision):
    """Each plain leaf at a tier is the float32 leaf's algebra on the
    tier's pieces of P (the twiddled butterfly) and of the bases: rounding
    the input instead gives another result."""
    x = torch.from_numpy(frames(2, (3, 24, 64)))
    xi = torch.from_numpy(frames(3, (3, 24, 64)))
    for got, (pr, pi), kind, n in (
            (fk.rfft_y_mixed_plain(x, precision),
             fk._bfly_lanes_plain(x, None, 64), "y", 64),
            (fk._fft_yc_plain(x, xi, precision),
             fk._bfly_lanes_plain(x, xi, 64), "y", 64)):
        bc, bs = (torch.from_numpy(a) for a in fk._BASES[kind](n)[:2])

        def dot(a, b):
            return fk.split_dot(a, b, precision)
        want = (dot(pr, bc) + dot(pi, bs), dot(pi, bc) - dot(pr, bs))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    rounded = fk.rfft_y_mixed_plain(x.to(torch.bfloat16).float())
    if precision == "default":
        assert rel(mixed(fk.rfft_y_mixed_plain(x, precision)),
                   mixed(rounded)) > 1e-4


# ----------------------------------------------- the pieces and tiles

@pytest.mark.parametrize("n", [16, 128, 1024])
def test_pieces_reconstruct_the_bases(n):
    """hi + lo is within 2⁻¹⁶ of each float32 basis value, three pieces
    within 2⁻²⁴, and each piece is a bf16 value."""
    for kind in ("y", "x"):
        for a in fk._BASES[kind](n)[:2]:
            b = torch.from_numpy(a)
            two = fk.pieces(b, 2)
            three = fk.pieces(b, 3)
            for p in three:
                assert torch.equal(p, p.to(torch.bfloat16).float())
            assert torch.all((b - (two[0] + two[1])).abs()
                             <= 2.0 ** -16 * b.abs())
            assert torch.all((b - (three[0] + three[1] + three[2])).abs()
                             <= 2.0 ** -24 * b.abs())
    cosb = pk._bases(4, n, torch.device("cpu"))[0]
    assert torch.all((cosb - sum(fk.pieces(cosb, 2))).abs()
                     <= 2.0 ** -16 * cosb.abs())


def _tile_matrix(flat: torch.Tensor, rows: int) -> torch.Tensor:
    """One tile in the kernels' core-matrix order back to ``[rows, 64]``."""
    return (flat.float().reshape(rows // 8, 8, 8, 8).transpose(1, 2)
            .reshape(rows, 64))


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("kind,n", [("y", 48), ("y", 128), ("x", 96),
                                    ("x", 16)])
def test_leaf_tiles_hold_each_tiers_product(kind, n, precision):
    """The B tiles as the leaf kernel reads them (frequency tile f, j chunk
    c, piece p; rows re | im of 32 frequencies, columns Pr | Pi of 32 j),
    times the A tiles' pieces of [Pr | Pi], summed over the tier's
    products: the tier-matched plain leaf."""
    gen = np.random.default_rng(4)
    rows = 37
    pr = torch.from_numpy(gen.normal(size=(4, rows, n // 4))
                          .astype(np.float32))
    pi = torch.from_numpy(gen.normal(size=(4, rows, n // 4))
                          .astype(np.float32))
    tiles = fk._leaf_tiles_on(kind, n, precision, torch.device("cpu"))
    bc, bs = (torch.from_numpy(a) for a in fk._BASES[kind](n)[:2])
    m1, K = bc.shape
    nf, nc = tiles.shape[:2]
    tf, jc = fk.LEAF_TILE
    got = torch.zeros(4, rows, 2, nf * tf)
    for f in range(nf):
        acc = torch.zeros(4, rows, 64)
        for c in range(nc):
            j = torch.arange(c * jc, (c + 1) * jc)
            ok = j < m1
            jj = torch.where(ok, j, 0)
            a = torch.cat([torch.where(ok, pr[..., jj], 0.0),
                           torch.where(ok, pi[..., jj], 0.0)], -1)
            ap = fk.pieces(a, fk._TIERS[precision] + 1)
            for i, k in fk._PRODUCTS[precision]:
                acc = acc + ap[i] @ _tile_matrix(tiles[f, c, k], 64).T
        got[..., f * tf:(f + 1) * tf] = acc.reshape(4, rows, 2, tf)

    def dot(a, b):
        return fk.split_dot(a, b, precision)
    want = (dot(pr, bc) + dot(pi, bs), dot(pi, bc) - dot(pr, bs))
    for part, w in enumerate(want):
        assert rel(got[:, :, part, :K], w) < LAYOUT_TOL


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("shape", [(2, 100, 130), (1, 64, 7)])
def test_ydft_tiles_hold_each_tiers_product(shape, precision):
    """P2's B tiles (bin tile b, y chunk c, piece p; rows cos | sin of 64
    bins, columns 64 y) times the pieces of x: each tier's plain energy."""
    x = torch.from_numpy(frames(5, shape, 1.0))
    d, nx, ny = shape
    nyr = ny // 2 + 1
    tiles = pk._ydft_tiles_on(ny, precision, torch.device("cpu"))
    w = pk._bases(nx, ny, torch.device("cpu"))[2]
    x2 = x.reshape(-1, ny)
    tb, ty = fk.SWEEP_TILE
    energy = 0.0
    for b in range(tiles.shape[0]):
        acc = torch.zeros(x2.shape[0], 2 * tb)
        for c in range(tiles.shape[1]):
            y = torch.arange(c * ty, (c + 1) * ty)
            a = torch.where(y < ny, x2[:, torch.where(y < ny, y, 0)], 0.0)
            ap = fk.pieces(a, fk._TIERS[precision] + 1)
            for i, k in fk._PRODUCTS[precision]:
                acc = acc + ap[i] @ _tile_matrix(tiles[b, c, k], 2 * tb).T
        bins = torch.arange(b * tb, (b + 1) * tb)
        wb = torch.where(bins < nyr, w[torch.where(bins < nyr, bins, 0)],
                         0.0)
        energy += float((wb * (acc[:, :tb] ** 2 + acc[:, tb:] ** 2)).sum())
    want = float(pk.ydft_energy_plain(x, precision=precision))
    assert abs(energy - want) / want < LAYOUT_TOL


# --------------------------------------------------------------- P2

def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "_tiers_probe_fused_dft",
        Path(__file__).resolve().parents[1] / "scripts" / "probe_fused_dft.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("precision", TIERS)
def test_ydft_energy_plain_tiers_match_jax_ref(precision):
    """Each tier's plain energy at the JAX probe's check case against the
    probe's own ``ref_energy`` (an rfft); the public function on the CPU
    stays float32 for every tier."""
    import jax.numpy as jnp
    x = frames(0, (3, 32, 48), 1.0)
    want = float(_jax_probe().ref_energy(jnp.asarray(x)))
    got = float(pk.ydft_energy_plain(torch.from_numpy(x), y_chunk=16,
                                     precision=precision))
    assert abs(got - want) / want < fk.p2_tier_tol(precision, x.size)
    cpu = float(pk.ydft_energy(torch.from_numpy(x), y_chunk=16,
                               precision=precision))
    assert cpu == float(pk.ydft_energy_plain(torch.from_numpy(x),
                                             y_chunk=16))


# ------------------------------------------------ routes and defaults

@pytest.mark.parametrize("route,tier,dtype", [
    ("fft", "high", None), ("fft-bf16", "default", torch.bfloat16)])
def test_fft_routes_pass_their_tiers(route, tier, dtype, monkeypatch):
    """The stream precompute's four-step routes call ``rfft2_mixed`` at
    the JAX package's tiers (spectralae/train/fft_corr.py:458-462)."""
    from spectralae_torch.train import fft_corr
    calls = []
    real = fft_corr.rfft2_mixed

    def recorder(x, **kw):
        calls.append(kw)
        return real(x, **kw)
    monkeypatch.setattr(fft_corr, "rfft2_mixed", recorder)
    gen = np.random.default_rng(6)
    x = torch.from_numpy(gen.normal(size=(2, 3, 16, 16))
                         .astype(np.float32) * 50)
    c = torch.from_numpy(gen.normal(size=(4, 3, 3, 3)).astype(np.float32))
    f = torch.from_numpy(gen.normal(size=(3, 4, 3, 3)).astype(np.float32))
    b = torch.zeros(4)
    p = torch.zeros(3)
    fft_corr.corr_precompute_fused(x, c, f, b, p, pallas_windows=route)
    assert len(calls) == 1
    assert calls[0].get("precision") == tier
    assert calls[0].get("out_dtype") == dtype


@pytest.mark.parametrize("precision,want", [(None, "default"),
                                            ("default", "default"),
                                            ("high", "high"),
                                            ("highest", "highest")])
def test_precision_none_runs_at_default_on_the_card(precision, want,
                                                    monkeypatch):
    """``precision=None`` resolves to ``"default"``, as in JAX
    (spectralae/ops/pallas_fft.py:471-472): the card route hands every leaf
    that tier (the launch recorded, not run)."""
    assert fk.tier(precision) == want
    seen = []

    def launch(entry, name, device, *args):
        seen.append((entry, args[-3]))     # the tier, then LEAF_TILE
    monkeypatch.setattr(fk, "_on_card", lambda t, name: True)
    monkeypatch.setattr(fk._kernels, "launch", launch)
    fk.rfft2_mixed(torch.zeros(2, 16, 32), precision=precision)
    assert seen == [("rfft_y_leaf_launch", fk._TIERS[want]),
                    ("fft_x_leaf_launch", fk._TIERS[want])]
    assert None in pk.PRECISIONS
