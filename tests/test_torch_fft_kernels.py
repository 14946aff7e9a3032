"""The port's four-step rfft2 (B5) against the JAX package and torch.fft.

Mirrors every case of tests/test_pallas_fft.py.  The same numpy frames go
through the JAX package's Pallas kernels in interpret mode (HIGHEST
precision, as its own tests run them) and through the port's wrappers,
which run their plain versions on CPU tensors.  Tolerances, each with its
reason:

- natural order: 2e-6 norm-relative against ``torch.fft.rfft2`` and JAX's
  ``rfft2_pallas`` — float32 matmul DFTs of at most 512 terms against a
  radix FFT (the JAX test's own bound);
- the stages alone and the raw mixed output: 1e-4 absolute per bin at unit
  scale (the JAX test's bound), 1e-5 of the largest bin for the maps;
- bf16 out: 6e-3 norm-relative, the 2^-9 rounding of the stored planes;
- the gather to natural order: exact.

Tests marked ``cuda`` launch the kernels against their plain versions on
the card and skip without one; they import no JAX::

    python -m pytest tests/test_torch_fft_kernels.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.ops import fft_kernels as fk

torch.set_num_threads(1)

NAT_TOL = 2e-6
BF16_TOL = 6e-3


def rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def frames(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            .astype(np.float32) * scale)


def mixed_np(Xre, Xim):
    return np.asarray(Xre, np.float32) + 1j * np.asarray(Xim, np.float32)


def _jax_fft():
    import jax
    from spectralae.ops import pallas_fft
    return pallas_fft, jax.lax.Precision.HIGHEST


@pytest.mark.parametrize("nx,ny", [(32, 32), (64, 32), (32, 64),
                                   (16, 48), (128, 128), (256, 64)])
def test_rfft2_natural_equality(nx, ny):
    import jax.numpy as jnp
    pf, HI = _jax_fft()
    x = frames(0, (2, 3, nx, ny), 7)
    before = _kernels.LAUNCHES.copy()
    got = fk.rfft2_pallas(torch.from_numpy(x))
    assert _kernels.LAUNCHES == before    # the CPU takes the plain versions
    assert got.dtype == torch.complex64
    assert rel(got, torch.fft.rfft2(torch.from_numpy(x))) < NAT_TOL
    want = pf.rfft2_pallas(jnp.asarray(x), precision=HI, interpret=True)
    assert rel(got, want) < NAT_TOL


@pytest.mark.parametrize("precision", ["default", "high", "highest", None])
def test_rfft2_precision_tiers(precision):
    """Every tier runs IEEE float32 products: at least as exact as the JAX
    HIGH tier's 1e-5 bound (test_pallas_fft.py::
    test_rfft2_high_tier_equality), and the same result for each tier."""
    x = torch.from_numpy(frames(3, (3, 64, 64), 7))
    got = fk.rfft2_pallas(x, precision=precision)
    assert rel(got, torch.fft.rfft2(x)) < 1e-5
    assert torch.equal(got, fk.rfft2_pallas(x))


def test_precision_and_shapes_are_checked():
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="precision"):
        fk.rfft2_mixed(x, precision="fast")
    with pytest.raises(ValueError, match="ny must be divisible by 4"):
        fk.rfft_y_mixed(torch.zeros(8, 6))
    with pytest.raises(ValueError, match="nx must be divisible by 4"):
        fk.fft_x_mixed(torch.zeros(6, 8), torch.zeros(6, 8))
    with pytest.raises(TypeError, match="float32"):
        fk.rfft_y_mixed(x.double())
    with pytest.raises(TypeError, match="out_dtype"):
        fk.fft_x_mixed(x, x, out_dtype=torch.float16)


@pytest.mark.parametrize("max_m1", [512, 8])
@pytest.mark.parametrize("n", [8, 16, 32, 48, 64, 128, 256, 1024, 2048,
                               4096])
def test_maps_equal_jax(n, max_m1, monkeypatch):
    """perm_x, perm_y, ny_padded and natural_gathers are the JAX package's,
    exactly, with and without the wrapper recursion."""
    pf, _ = _jax_fft()
    monkeypatch.setattr(pf, "_MAX_M1", max_m1)
    monkeypatch.setattr(fk, "_MAX_M1", max_m1)
    assert np.array_equal(fk.perm_x(n), pf.perm_x(n))
    assert np.array_equal(fk.perm_y(n), pf.perm_y(n))
    assert fk.ny_padded(n) == pf.ny_padded(n)
    for a, b in zip(fk.natural_gathers(n, n), pf.natural_gathers(n, n)):
        assert np.array_equal(a, b)


def test_mixed_order_maps():
    """The raw mixed-order output + (perm_x, perm_y) IS the spectrum."""
    nx, ny = 64, 32
    x = frames(1, (nx, ny))
    Xre, Xim = fk.rfft2_mixed(torch.from_numpy(x))
    assert Xre.shape == (nx, fk.ny_padded(ny))
    ref = np.fft.rfft2(x)
    px, py = fk.perm_x(nx), fk.perm_y(ny)
    got = mixed_np(Xre, Xim)
    ok = py >= 0
    scale = np.abs(ref).max()
    assert np.abs(got[px.argsort()][:, ok][:, py[ok].argsort()]
                  - ref).max() < 1e-5 * scale
    row_of, lane_of = fk.natural_gathers(nx, ny)
    assert np.abs(got[row_of][:, lane_of] - ref).max() < 1e-5 * scale


def test_y_stage_alone():
    """rfft_y_mixed = rfft along the last axis, in mixed lanes."""
    nx, ny = 16, 64
    x = frames(2, (nx, ny))
    Yre, Yim = fk.rfft_y_mixed(torch.from_numpy(x))
    ref = np.fft.rfft(x, axis=-1)
    py = fk.perm_y(ny)
    got = mixed_np(Yre, Yim).reshape(4, nx, -1)
    k1p = got.shape[-1]
    for lane in range(4 * k1p):
        k2, k1 = divmod(lane, k1p)
        if py[lane] >= 0:
            np.testing.assert_allclose(got[k2, :, k1], ref[:, py[lane]],
                                       rtol=0, atol=1e-4)


def test_x_stage_alone():
    """fft_x_mixed = full complex FFT along -2, mixed rows, lanes kept."""
    nx, L = 64, 8
    yr, yi = frames(3, (nx, L)), frames(4, (nx, L))
    Xre, Xim = fk.fft_x_mixed(torch.from_numpy(yr), torch.from_numpy(yi),
                              lane_chunk=4)
    ref = np.fft.fft(yr + 1j * yi, axis=0)
    np.testing.assert_allclose(mixed_np(Xre, Xim)[fk.perm_x(nx).argsort()],
                               ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_bf16_output_dtype():
    nx, ny = 32, 32
    x = frames(4, (nx, ny))
    Xre, Xim = fk.rfft2_mixed(torch.from_numpy(x), out_dtype=torch.bfloat16)
    assert Xre.dtype == torch.bfloat16 and Xim.dtype == torch.bfloat16
    row_of, lane_of = fk.natural_gathers(nx, ny)
    got = mixed_np(Xre.float(), Xim.float())[row_of][:, lane_of]
    assert rel(got, np.fft.rfft2(x)) < BF16_TOL


@pytest.mark.parametrize("nx,ny", [(64, 64), (128, 64), (64, 128),
                                   (256, 256)])
def test_wrapper_recursion_equality(nx, ny, monkeypatch):
    """Axes longer than 4·_MAX_M1 peel butterfly rounds; shrinking _MAX_M1
    in both packages forces 1–3 rounds at small sizes."""
    import jax.numpy as jnp
    pf, HI = _jax_fft()
    monkeypatch.setattr(pf, "_MAX_M1", 8)
    monkeypatch.setattr(fk, "_MAX_M1", 8)
    x = frames(7, (2, nx, ny), 5)
    got = fk.rfft2_pallas(torch.from_numpy(x))
    assert rel(got, np.fft.rfft2(x)) < NAT_TOL
    want = pf.rfft2_pallas(jnp.asarray(x), precision=HI, interpret=True)
    assert rel(got, want) < NAT_TOL
    py = fk.perm_y(ny)
    assert sorted(py[py >= 0]) == list(range(ny // 2 + 1))
    assert sorted(fk.perm_x(nx)) == list(range(nx))


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_lead_chunk_equality(chunk):
    """``lead_chunk`` is accepted and changes nothing here: the port's
    output equals its unchunked one bit for bit, and JAX's serialized
    transform at the same chunk (including a non-divisor) on live lanes."""
    import jax.numpy as jnp
    pf, HI = _jax_fft()
    x = frames(11, (3, 64, 64), 5)
    got = fk.rfft2_mixed(torch.from_numpy(x), lead_chunk=chunk)
    ref = fk.rfft2_mixed(torch.from_numpy(x))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    want = mixed_np(*pf.rfft2_mixed(jnp.asarray(x), precision=HI,
                                    interpret=True, lead_chunk=chunk))
    live = fk.perm_y(64) >= 0
    got = mixed_np(*got)[..., live]
    assert np.abs(got - want[..., live]).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("max_m1", [512, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_natural_is_the_numpy_gather(max_m1, dtype, monkeypatch):
    """gather_natural takes each natural bin from its mixed position
    (natural_gathers), keeps the planes' dtype, and to_natural is the same
    gather as complex64."""
    monkeypatch.setattr(fk, "_MAX_M1", max_m1)
    nx, ny = 64, 128
    planes = fk.rfft2_mixed(torch.from_numpy(frames(17, (2, 3, nx, ny))),
                            out_dtype=dtype)
    row_of, lane_of = fk.natural_gathers(nx, ny)
    got = fk.gather_natural(planes, nx, ny)
    for g, p in zip(got, planes):
        assert g.dtype == dtype and g.shape == (2, 3, nx, ny // 2 + 1)
        assert torch.equal(g, p[..., row_of, :][..., lane_of])
    nat = fk.to_natural(planes, nx, ny)
    assert torch.equal(nat, torch.complex(got[0].float(), got[1].float()))


def test_batched_leading_dims():
    x = frames(5, (2, 2, 3, 32, 48))
    got = fk.rfft2_pallas(torch.from_numpy(x))
    ref = np.fft.rfft2(x)
    assert got.shape == ref.shape
    assert rel(got, ref) < NAT_TOL


@pytest.mark.parametrize("nx,ny,max_m1", [(32, 48, 512), (128, 64, 512),
                                          (64, 128, 8)])
def test_raw_mixed_output_matches_jax(nx, ny, max_m1, monkeypatch):
    """The raw mixed-order planes equal JAX's on every live lane (the dead
    lanes are beyond-Nyquist values or zeros, finite in both)."""
    import jax.numpy as jnp
    pf, HI = _jax_fft()
    monkeypatch.setattr(pf, "_MAX_M1", max_m1)
    monkeypatch.setattr(fk, "_MAX_M1", max_m1)
    x = frames(9, (2, nx, ny), 3)
    got = mixed_np(*fk.rfft2_mixed(torch.from_numpy(x)))
    want = mixed_np(*pf.rfft2_mixed(jnp.asarray(x), precision=HI,
                                    interpret=True))
    assert got.shape == want.shape == (2, nx, fk.ny_padded(ny))
    assert np.isfinite(got).all()
    live = fk.perm_y(ny) >= 0
    scale = np.abs(want[..., live]).max()
    assert np.abs(got[..., live] - want[..., live]).max() < 1e-5 * scale


@pytest.mark.parametrize("real", [True, False])
def test_butterfly_rounds_match_jax(real):
    """The plain lane and row rounds against the JAX package's Pallas
    rounds (interpret mode)."""
    import jax.numpy as jnp
    pf, _ = _jax_fft()
    xr, xi = frames(13, (2, 8, 64)), frames(14, (2, 8, 64))
    got = fk._bfly_lanes(torch.from_numpy(xr),
                         None if real else torch.from_numpy(xi), 64)
    want = pf._bfly_lanes(jnp.asarray(xr), None if real else jnp.asarray(xi),
                          64, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    yr, yi = frames(15, (2, 64, 12)), frames(16, (2, 64, 12))
    got = fk._bfly_rows(torch.from_numpy(yr), torch.from_numpy(yi), 64)
    want = pf._bfly_rows(jnp.asarray(yr), jnp.asarray(yi), 64, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


# ------------------------------------------------------- on the card

# the kernels multiply the same bf16 pieces as the tier-matched plain
# versions (exact float32 products) and sum them in another order (at most
# 2·512 terms a bin, times the tier's products)
CARD_TOL = 1e-5
# each tier against the exact transform: fft_kernels.TIER_TOL
TIERS, TIER_TOL = fk.TIERS, fk.TIER_TOL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_rel(got, want) -> float:
    wide = torch.complex128 if want.is_complex() else torch.float64
    got, want = got.to(wide).cpu(), want.to(wide).cpu()
    return float((got - want).norm() / want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("BD,R,n", [(24, 128, 128), (3, 1024, 1024),
                                    (2, 40, 2048), (1, 3, 16), (2, 100, 48),
                                    (5, 70, 32)])
def test_y_leaf_kernels_match_plain(cuda_device, BD, R, n, precision):
    """Row counts that are no multiple of 64, k1p = 24 (n = 128), m1 = 4,
    8 and 12 (a partial 32-j chunk), against the tier-matched plain
    versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    xr = torch.randn(BD, R, n, device=cuda_device, generator=gen)
    xi = torch.randn(BD, R, n, device=cuda_device, generator=gen)
    before = _kernels.LAUNCHES.copy()
    real = fk._y_leaf(xr, None, precision)
    cplx = fk._y_leaf(xr, xi, precision)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["rfft_y_mixed"] == before["rfft_y_mixed"] + 1
    assert _kernels.LAUNCHES["fft_yc"] == before["fft_yc"] + 1
    for g, w in zip(real, fk.rfft_y_mixed_plain(xr, precision)):
        assert _card_rel(g, w) < CARD_TOL
    for g, w in zip(cplx, fk._fft_yc_plain(xr, xi, precision)):
        assert _card_rel(g, w) < CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("BD,nx,L", [(96, 128, 24), (12, 1024, 160),
                                     (4, 2048, 37), (1, 16, 8), (3, 96, 70)])
@pytest.mark.parametrize("bf16", [False, True])
def test_x_leaf_kernel_matches_plain(cuda_device, BD, nx, L, bf16,
                                     precision):
    """Lane counts that are no multiple of 64 against the tier-matched
    plain version; bf16 out against its float32 planes (the storage
    rounding)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    yr = torch.randn(BD, nx, L, device=cuda_device, generator=gen)
    yi = torch.randn(BD, nx, L, device=cuda_device, generator=gen)
    out = torch.bfloat16 if bf16 else None
    before = _kernels.LAUNCHES["fft_x_mixed"]
    got = fk.fft_x_mixed(yr, yi, out_dtype=out, precision=precision)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["fft_x_mixed"] == before + 1
    assert got[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    for g, w in zip(got, fk.fft_x_mixed_plain(yr, yi, None, precision)):
        assert _card_rel(g.float(), w) < (BF16_TOL if bf16 else CARD_TOL)


@pytest.mark.cuda
def test_butterfly_round_kernels_match_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    xr = torch.randn(3, 40, 64, device=cuda_device, generator=gen)
    xi = torch.randn(3, 40, 64, device=cuda_device, generator=gen)
    before = _kernels.LAUNCHES.copy()
    for got, want in ((fk._bfly_lanes(xr, None, 64),
                       fk._bfly_lanes_plain(xr, None, 64)),
                      (fk._bfly_lanes(xr, xi, 64),
                       fk._bfly_lanes_plain(xr, xi, 64)),
                      (fk._bfly_rows(xr.transpose(1, 2).contiguous(),
                                     xi.transpose(1, 2).contiguous(), 64),
                       fk._bfly_rows_plain(xr.transpose(1, 2),
                                           xi.transpose(1, 2), 64))):
        for g, w in zip(got, want):
            assert _card_rel(g, w) < CARD_TOL
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["bfly_lanes"] == before["bfly_lanes"] + 2
    assert _kernels.LAUNCHES["bfly_rows"] == before["bfly_rows"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("bf16", [False, True])
def test_forced_recursion_on_the_card(cuda_device, bf16, precision,
                                      monkeypatch):
    """Every kernel of the recursion (lane and row rounds, the complex
    y-leaf of m1 = 4) at _MAX_M1 = 8: the card's rfft2_mixed against the
    plain x-stage at its tier on the card's own y-stage, and against
    torch.fft.rfft2 within the tier's bound (bf16 out: the storage
    rounding)."""
    monkeypatch.setattr(fk, "_MAX_M1", 8)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(2, 3, 256, 256, device=cuda_device, generator=gen)
    out = torch.bfloat16 if bf16 else None
    before = _kernels.LAUNCHES.copy()
    got = fk.rfft2_mixed(x, precision=precision, out_dtype=out)
    torch.cuda.synchronize()
    grew = {k: _kernels.LAUNCHES[k] - before[k] for k in (
        "rfft_y_mixed", "fft_yc", "bfly_lanes", "bfly_rows", "fft_x_mixed")}
    # y: 2 lane rounds, then the complex leaf; x: 2 row rounds, the leaf
    # (256 -> 64 -> 16 on each axis)
    assert grew == {"rfft_y_mixed": 0, "fft_yc": 1, "bfly_lanes": 2,
                    "bfly_rows": 2, "fft_x_mixed": 1}
    # the plain x-stage on the kernels' own y-stage: at "default" the
    # x-leaf rounds to bf16 a y-stage output that kernel and plain sum in
    # other orders, so from x alone a value near a rounding boundary moves
    # by 2^-8
    want = fk.rfft2_mixed_plain(
        x, precision=precision,
        y_planes=fk.rfft_y_mixed(x, precision=precision))
    tol = BF16_TOL if bf16 else CARD_TOL
    for g, w in zip(got, want):
        assert _card_rel(g.float(), w) < tol
    nat = fk.to_natural(got, 256, 256)
    assert _card_rel(nat, torch.fft.rfft2(x)) < max(
        TIER_TOL[precision], BF16_TOL if bf16 else 0.0)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fk.rfft2_mixed(x)
