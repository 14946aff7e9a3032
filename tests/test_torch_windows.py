"""The port's window kernels (K3, K4) against the JAX package (CPU).

On the CPU the wrappers run their plain PyTorch versions; the JAX package's
Pallas kernels ``corr_pair_windows`` and ``anchor_windows`` run in interpret
mode, as its own tests run them, and its XLA formulation runs as it is.
Tolerance: norm-relative 1e-6 — the same float32 products summed in
another order (the FFTs are taken once, by JAX, and handed to both).

Tests marked ``cuda`` launch the hand-written kernels against their plain
versions on the card and skip without one; they import no JAX::

    python -m pytest tests/test_torch_windows.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.ops import window_kernels as wk

torch.set_num_threads(1)

TOL = 1e-6
# the bf16 signal rounds X's planes by up to 2^-9 relative; the windows of
# the rounded signal stay within 2e-2 of the unrounded ones (the JAX
# package's own bound, tests/test_pallas_windows.py)
BF16_BAND = 2e-2


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def spectra(rng, b, c, nx, ny, scale=1.0):
    """Half-spectra of random real frames, complex64 numpy."""
    x = rng.standard_normal((b, c, nx, ny)).astype(np.float32) * scale
    return np.fft.rfft2(x).astype(np.complex64)


def rand_spec(rng, b, c, nx, nyr):
    return (rng.standard_normal((b, c, nx, nyr))
            + 1j * rng.standard_normal((b, c, nx, nyr))).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


# ------------------------------------------------------------------- K3

@pytest.mark.parametrize("B,D,E,nx,ny,hx,hy", [
    (2, 3, 3, 32, 32, 4, 4),      # square
    (1, 2, 3, 24, 16, 3, 2),      # cross-correlation, D != E, non-square
    (3, 1, 1, 16, 18, 5, 5),      # window wider than grid/2 (aliasing)
    (2, 2, 2, 16, 19, 2, 3),      # odd ny (nyr = 10)
])
def test_corr_pair_windows_matches_jax(B, D, E, nx, ny, hx, hy):
    import jax.numpy as jnp
    from spectralae.ops.pallas_windows import corr_pair_windows
    from spectralae.train import fft_corr
    rng = np.random.default_rng(B * 1000 + D * 100 + E * 10 + nx)
    nyr = ny // 2 + 1
    X, Z = rand_spec(rng, B, D, nx, nyr), rand_spec(rng, B, E, nx, nyr)
    before = _kernels.LAUNCHES.copy()
    got = wk.corr_pair_windows(_t(X), _t(Z), nx, ny, hx, hy)
    assert _kernels.LAUNCHES == before     # the CPU takes the plain version
    assert got.shape == (D, E, 2 * hx + 1, 2 * hy + 1)
    want = corr_pair_windows(jnp.asarray(X), jnp.asarray(Z), nx, ny, hx, hy,
                             interpret=True)
    assert rel(got, want) < TOL
    # and the JAX XLA formulation it fuses
    prods = jnp.mean(jnp.conj(X)[:, :, None] * Z[:, None],
                     axis=0).reshape(D * E, nx, nyr)
    xla = fft_corr._corr_windows(prods, nx, ny, hx, hy)
    assert rel(got.reshape(D * E, -1), np.asarray(xla).reshape(D * E, -1)) \
        < TOL


def test_corr_pair_windows_autocorrelation_mirror():
    """``Z is X``: the windows of conj(X_d)·X_e are those of conj(X_e)·X_d
    at the reversed lag, W[e,d](l) = W[d,e](−l)."""
    rng = np.random.default_rng(7)
    X = _t(rand_spec(rng, 2, 3, 32, 17))
    got = wk.corr_pair_windows(X, X, 32, 32, 4, 4)
    mirrored = torch.flip(got.transpose(0, 1), dims=(-2, -1))
    assert rel(got, mirrored) < TOL
    assert rel(got, wk.corr_pair_windows_plain(X, X.clone(), 32, 32, 4, 4)) \
        < TOL


# ------------------------------------------------------------------- K4

def _anchor_problem(seed, B, D, nx, ny, nk2, scale=1.0):
    rng = np.random.default_rng(seed)
    X = spectra(rng, B, D, nx, ny, scale)
    taps = (rng.standard_normal((D, D, nk2, nk2)) * 0.2).astype(np.float32)
    return X, taps, nk2 // 2, 1.0 / (4 * D)


@pytest.mark.parametrize("B,D,nx,ny,nk2", [
    (2, 3, 16, 16, 9),
    (1, 2, 24, 24, 5),
    (1, 2, 16, 19, 5),     # odd ny (nyr = 10)
    (2, 3, 20, 12, 9),     # non-square, window wider than the grid
])
def test_anchor_windows_matches_jax(B, D, nx, ny, nk2):
    import jax.numpy as jnp
    from spectralae.ops import dft as jdft
    from spectralae.ops import spectral as jspec
    from spectralae.ops.pallas_windows import anchor_windows
    from spectralae.train import fft_corr
    X, taps, h2, s1 = _anchor_problem(B * 100 + D, B, D, nx, ny, nk2)
    before = _kernels.LAUNCHES.copy()
    got = wk.anchor_windows(_t(X), _t(taps), nx, ny, h2, h2, s1)
    assert _kernels.LAUNCHES == before
    pallas = anchor_windows(jnp.asarray(X), jnp.asarray(taps), nx, ny, h2,
                            h2, s1, interpret=True)
    for name, g, w in zip(("XX", "EGw", "seg", "e0"), got, pallas):
        assert g.shape == w.shape, name
        assert rel(g, w) < TOL, name
    # the XLA formulation (fft_corr.py:504-527) with the same outputs
    Xj = jnp.asarray(X)
    K0f = jdft.kernel_spectrum(jnp.asarray(taps), nx, ny, precision="high")
    EG = jnp.sum(K0f[None] * Xj[:, None], axis=2) * s1 - Xj
    nyr = ny // 2 + 1

    def win(A, Bm, h):
        prods = jnp.mean(jnp.conj(A)[:, :, None] * Bm[:, None],
                         axis=0).reshape(D * D, nx, nyr)
        return fft_corr._corr_windows(prods, nx, ny, h, h)
    wv = jnp.asarray(jspec._hermitian_weights(nx, ny))
    xla = (win(Xj, Xj, 2 * h2), win(Xj, EG, h2),
           jnp.mean(jnp.sum((EG.real ** 2 + EG.imag ** 2) * wv,
                            axis=(-3, -2, -1))),
           jnp.mean(EG[:, :, 0, 0].real, axis=0))
    for name, g, w in zip(("XX", "EGw", "seg", "e0"), got, xla):
        assert rel(np.asarray(g).reshape(np.shape(w)), w) < TOL, name


@pytest.mark.parametrize("B,D,nx,ny,nk2", [
    (2, 3, 16, 16, 5), (1, 2, 16, 19, 5), (2, 3, 20, 12, 9)])
def test_anchor_windows_xx_mirror(B, D, nx, ny, nk2):
    """The kernel computes the upper XX pairs only and mirrors the rest:
    XX[e,d](l) = XX[d,e](−l) must hold for the whole tensor."""
    X, taps, h2, s1 = _anchor_problem(3, B, D, nx, ny, nk2)
    XX = wk.anchor_windows(_t(X), _t(taps), nx, ny, h2, h2, s1)[0]
    assert rel(XX, torch.flip(XX.transpose(0, 1), dims=(-2, -1))) < TOL


def test_anchor_windows_bf16_is_exact_on_rounded_signal():
    """The bf16 signal computes the exact float32 answer for the
    bf16-rounded signal (both EG terms share the rounded X), within the
    bf16 band of the unrounded one, and equals the JAX package's bf16
    route."""
    import jax.numpy as jnp
    from spectralae.ops.pallas_windows import anchor_windows
    X, taps, h2, s1 = _anchor_problem(7, 2, 3, 16, 16, 9, scale=1e3)
    Xt, tt = _t(X), _t(taps)
    got = wk.anchor_windows(Xt, tt, 16, 16, h2, h2, s1,
                            signal_dtype=torch.bfloat16)
    Xr = torch.complex(Xt.real.bfloat16().float(), Xt.imag.bfloat16().float())
    want = wk.anchor_windows(Xr, tt, 16, 16, h2, h2, s1)
    full = wk.anchor_windows(Xt, tt, 16, 16, h2, h2, s1)
    jax_bf16 = anchor_windows(jnp.asarray(X), jnp.asarray(taps), 16, 16, h2,
                              h2, s1, signal_dtype=jnp.bfloat16,
                              interpret=True)
    for g, w, f, j in zip(got, want, full, jax_bf16):
        assert rel(g, w) < TOL
        assert rel(g, j) < TOL
        assert rel(g, f) < BF16_BAND


# -------------------------------------- K4's row slabs (tensor parallel)

def _slabs(X, chunk):
    """``X`` zero-padded to whole slabs of ``chunk`` rows, and the slabs
    with their start rows (24 rows in slabs of 10: 10/10/4, the last one
    padded by 6 rows, as tests/test_pallas_windows.py cuts them)."""
    n = -(-X.shape[-2] // chunk)
    Xp = np.pad(X, ((0, 0), (0, 0), (0, n * chunk - X.shape[-2]), (0, 0)))
    return [(i * chunk, Xp[:, :, i * chunk:(i + 1) * chunk])
            for i in range(n)]


@pytest.mark.parametrize("bf16", [False, True])
def test_anchor_windows_row_slab_matches_jax(bf16):
    """Each slab's partials, the padded end slab included, against the
    JAX kernel's ``row_slab`` mode in interpret mode (float32 and bf16
    signal); ``e0`` against JAX's on the slab that holds row 0, and 0 on
    the others (JAX leaves theirs undefined)."""
    import jax.numpy as jnp
    from spectralae.ops.pallas_windows import anchor_windows
    B, D, nx, ny, nk2 = 2, 2, 24, 16, 5
    X, taps, h2, s1 = _anchor_problem(17, B, D, nx, ny, nk2)
    sd = torch.bfloat16 if bf16 else None
    for row0, Xl in _slabs(X, 10):
        got = wk.anchor_windows(_t(Xl), _t(taps), nx, ny, h2, h2, s1,
                                row_slab=row0, signal_dtype=sd)
        want = anchor_windows(jnp.asarray(Xl), jnp.asarray(taps), nx, ny,
                              h2, h2, s1, row_slab=row0, interpret=True,
                              signal_dtype=jnp.bfloat16 if bf16 else None)
        for name, g, w in zip(("XX", "EGw", "seg"), got, want):
            assert rel(g, w) < TOL, (row0, name)
        if row0 == 0:
            assert rel(got[3], want[3]) < TOL
        else:
            assert not got[3].any()


@pytest.mark.parametrize("chunk", [12, 10, 7])
def test_anchor_windows_row_slab_partials_sum_to_the_full_call(chunk):
    """The partials of a disjoint cover of the rows sum to the full call
    (2 slabs, 3 with a padded end, 4 with a padded end): the windows and
    seg are linear or additive over the rows, e0 comes from row 0."""
    B, D, nx, ny, nk2 = 2, 3, 24, 16, 5
    X, taps, h2, s1 = _anchor_problem(18, B, D, nx, ny, nk2)
    full = wk.anchor_windows(_t(X), _t(taps), nx, ny, h2, h2, s1)
    parts = [wk.anchor_windows(_t(Xl), _t(taps), nx, ny, h2, h2, s1,
                               row_slab=row0)
             for row0, Xl in _slabs(X, chunk)]
    for i, name in enumerate(("XX", "EGw", "seg", "e0")):
        assert rel(sum(p[i] for p in parts), full[i]) < TOL, name


def test_anchor_windows_row_slab_checks_its_input():
    X, taps, h2, s1 = _anchor_problem(19, 1, 2, 16, 16, 5)
    with pytest.raises(ValueError, match="row-slab"):
        wk.anchor_windows((_t(X.real.copy()), _t(X.imag.copy())), _t(taps),
                          16, 16, h2, h2, s1, row_slab=0, mixed=True)
    with pytest.raises(ValueError, match="row_slab"):
        wk.anchor_windows(_t(X), _t(taps), 16, 16, h2, h2, s1, row_slab=-1)
    with pytest.raises(ValueError, match="do not match"):
        wk.anchor_windows(_t(X[..., :-1]), _t(taps), 16, 16, h2, h2, s1,
                          row_slab=0)
    # a slab wholly past the grid's rows holds nothing
    zero = wk.anchor_windows(_t(X), _t(taps), 16, 16, h2, h2, s1,
                             row_slab=16)
    assert not any(t.any() for t in zero)


# ------------------------------------------------- K4 in mixed bin order

def _mixed_problem(seed, B, D, nx, ny, nk2, out_dtype=None):
    """Frames, their rfft2_mixed planes (the port's, plain on the CPU)
    and taps."""
    from spectralae_torch.ops import fft_kernels as fk
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, nx, ny)).astype(np.float32) * 30
    planes = fk.rfft2_mixed(_t(x), out_dtype=out_dtype)
    taps = (rng.standard_normal((D, D, nk2, nk2)) * 0.2).astype(np.float32)
    return x, planes, taps, nk2 // 2, 1.0 / (4 * D)


@pytest.mark.parametrize("B,D,nx,ny,nk2,max_m1,bf16", [
    (2, 3, 16, 16, 9, 512, False),
    (1, 2, 32, 48, 5, 512, False),
    (2, 3, 64, 32, 9, 8, False),       # forced recursion on both axes
    (2, 3, 16, 16, 9, 512, True)])     # bf16 planes
def test_anchor_windows_mixed_matches_jax(B, D, nx, ny, nk2, max_m1, bf16,
                                          monkeypatch):
    """The port's K4 on mixed planes (gathered to natural order) against
    JAX's ``anchor_windows(mixed=True)`` (permuted constants, interpret
    mode) on the same planes, and against the port's natural route on the
    same spectra."""
    import jax.numpy as jnp
    from spectralae.ops import pallas_fft as jfft
    from spectralae.ops.pallas_windows import anchor_windows
    from spectralae_torch.ops import fft_kernels as fk
    monkeypatch.setattr(fk, "_MAX_M1", max_m1)
    monkeypatch.setattr(jfft, "_MAX_M1", max_m1)
    x, (Xre, Xim), taps, h2, s1 = _mixed_problem(
        B + nx, B, D, nx, ny, nk2, torch.bfloat16 if bf16 else None)
    before = _kernels.LAUNCHES.copy()
    got = wk.anchor_windows((Xre, Xim), _t(taps), nx, ny, h2, h2, s1,
                            mixed=True)
    assert _kernels.LAUNCHES == before
    as_jax = (jnp.asarray(Xre.float().numpy()).astype(jnp.bfloat16)
              if bf16 else jnp.asarray(Xre.numpy()))
    as_jax_im = (jnp.asarray(Xim.float().numpy()).astype(jnp.bfloat16)
                 if bf16 else jnp.asarray(Xim.numpy()))
    want = anchor_windows((as_jax, as_jax_im), jnp.asarray(taps), nx, ny, h2,
                          h2, s1, mixed=True, interpret=True)
    natural = wk.anchor_windows(fk.to_natural((Xre, Xim), nx, ny), _t(taps),
                                nx, ny, h2, h2, s1)
    for name, g, w, n in zip(("XX", "EGw", "seg", "e0"), got, want,
                             natural):
        assert g.shape == w.shape, name
        assert rel(g, w) < TOL, name
        assert rel(g, n) < TOL, name


def test_anchor_windows_mixed_checks_its_input():
    _, (Xre, Xim), taps, h2, s1 = _mixed_problem(0, 1, 2, 16, 16, 5)
    with pytest.raises(ValueError, match="row-slab"):
        wk.anchor_windows((Xre, Xim), _t(taps), 16, 16, h2, h2, s1,
                          mixed=True, row_slab=0)
    with pytest.raises(ValueError, match="unsliced"):
        wk.anchor_windows((Xre[..., :9], Xim[..., :9]), _t(taps), 16, 16, h2,
                          h2, s1, mixed=True)
    with pytest.raises(TypeError, match="pair"):
        wk.anchor_windows(Xre, _t(taps), 16, 16, h2, h2, s1, mixed=True)


# ------------------------------------------------------- on the card

# the kernels sum in another order than the plain versions' matmuls, and
# K4 builds the anchor spectra through its own 81-term sums
CARD_TOL = 1e-5


def _repeated(fn):
    """One launch and two more, held bit for bit (the kernels' sums have a
    fixed order); the first result."""
    runs = [fn() for _ in range(3)]
    torch.cuda.synchronize()
    for again in runs[1:]:
        for a, b in zip(runs[0] if isinstance(runs[0], tuple) else (runs[0],),
                        again if isinstance(again, tuple) else (again,)):
            assert torch.equal(a, b)
    return runs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,E,n,ny,h,same", [
    (8, 3, 3, 128, 128, 4, True), (2, 2, 3, 40, 40, 3, False),
    (1, 3, 3, 33, 33, 5, True), (2, 2, 2, 24, 30, 2, True),
    (1, 3, 3, 8, 6600, 4, False)])    # nyr 3301: two ω_y chunks
def test_corr_pair_windows_kernel_matches_plain(cuda_device, B, D, E, n, ny,
                                                h, same):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(B, D, n, ny, device=cuda_device, generator=gen)
    X = torch.fft.rfft2(x)
    Z = X if same else torch.fft.rfft2(torch.randn(
        B, E, n, ny, device=cuda_device, generator=gen))
    before = _kernels.LAUNCHES["corr_pair_windows"]
    got = _repeated(lambda: wk.corr_pair_windows(X, Z, n, ny, h, h))
    assert _kernels.LAUNCHES["corr_pair_windows"] == before + 3
    want = wk.corr_pair_windows_plain(X, Z, n, ny, h, h)
    assert rel(got.cpu(), want.cpu()) < CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,chunk,bf16", [
    (8, 128, 64, False), (8, 128, 32, True), (4, 100, 48, False),
    (2, 48, 20, True)])
def test_anchor_windows_row_slab_kernel_matches_plain(cuda_device, B, n,
                                                      chunk, bf16):
    """Each slab on the card (padded end slabs where ``chunk`` does not
    divide ``n``) against its plain version, three runs bit for bit, and
    the slabs' sum against the full kernel call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    D, nk2 = 3, 9
    X = torch.fft.rfft2(torch.randn(B, D, n, n, device=cuda_device,
                                    generator=gen))
    taps = torch.randn(D, D, nk2, nk2, device=cuda_device, generator=gen) * .2
    sd = torch.bfloat16 if bf16 else None
    h2, s1 = nk2 // 2, 1 / (4 * D)
    nsl = -(-n // chunk)
    Xp = torch.nn.functional.pad(X, (0, 0, 0, nsl * chunk - n))
    before = _kernels.LAUNCHES["anchor_windows"]
    parts = []
    for i in range(nsl):
        Xl = Xp[:, :, i * chunk:(i + 1) * chunk]
        got = _repeated(lambda: wk.anchor_windows(
            Xl, taps, n, n, h2, h2, s1, row_slab=i * chunk, signal_dtype=sd))
        want = wk.anchor_windows_plain(Xl, taps, n, n, h2, h2, s1,
                                       row_slab=i * chunk, signal_dtype=sd)
        for name, g, w in zip(("XX", "EGw", "seg"), got, want):
            assert rel(g.cpu(), w.cpu()) < CARD_TOL, (i, name)
        assert i == 0 or not got[3].any()
        parts.append(got)
    assert _kernels.LAUNCHES["anchor_windows"] == before + 3 * nsl
    full = wk.anchor_windows(X, taps, n, n, h2, h2, s1, signal_dtype=sd)
    for k, name in enumerate(("XX", "EGw", "seg", "e0")):
        assert rel(sum(p[k] for p in parts).cpu(), full[k].cpu()) < CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,n,ny,nk2,bf16", [
    (8, 3, 128, 128, 9, False), (8, 3, 128, 128, 9, True),
    (2, 2, 48, 30, 5, False), (1, 3, 64, 64, 9, False),
    (1, 2, 8, 5400, 5, False)])       # nyr 2701: two ω_y chunks
def test_anchor_windows_kernel_matches_plain(cuda_device, B, D, n, ny, nk2,
                                             bf16):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    X = torch.fft.rfft2(torch.randn(B, D, n, ny, device=cuda_device,
                                    generator=gen))
    taps = torch.randn(D, D, nk2, nk2, device=cuda_device, generator=gen) * .2
    sd = torch.bfloat16 if bf16 else None
    before = _kernels.LAUNCHES["anchor_windows"]
    got = _repeated(lambda: wk.anchor_windows(
        X, taps, n, ny, nk2 // 2, nk2 // 2, 1 / (4 * D), signal_dtype=sd))
    assert _kernels.LAUNCHES["anchor_windows"] == before + 3
    want = wk.anchor_windows_plain(X, taps, n, ny, nk2 // 2, nk2 // 2,
                                   1 / (4 * D), signal_dtype=sd)
    for name, g, w in zip(("XX", "EGw", "seg", "e0"), got, want):
        assert rel(g.cpu(), w.cpu()) < CARD_TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,bf16", [(8, 128, False), (8, 128, True),
                                      (1, 1024, False), (2, 40, True)])
def test_anchor_windows_mixed_kernel_matches_plain(cuda_device, B, n, bf16):
    """K4 on the four-step FFT's mixed planes (float32 and bf16) against
    its plain version, which gathers them to natural order."""
    from spectralae_torch.ops import fft_kernels as fk
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.rand(B, 3, n, n, device=cuda_device, generator=gen) * 255
    planes = fk.rfft2_mixed(x, out_dtype=torch.bfloat16 if bf16 else None)
    taps = torch.randn(3, 3, 9, 9, device=cuda_device, generator=gen) * .2
    before = _kernels.LAUNCHES["anchor_windows"]
    got = _repeated(lambda: wk.anchor_windows(planes, taps, n, n, 4, 4,
                                              1 / 30, mixed=True))
    assert _kernels.LAUNCHES["anchor_windows"] == before + 3
    want = wk.anchor_windows_plain(planes, taps, n, n, 4, 4, 1 / 30,
                                   mixed=True)
    for name, g, w in zip(("XX", "EGw", "seg", "e0"), got, want):
        assert rel(g.cpu(), w.cpu()) < CARD_TOL, name


# explicit tilings on the card: a partial row tile (nx not a multiple of
# the rows), several batch groups, ω_y chunks whose steps do not divide
# them (or pass them), one row a block, and the plan's own at a D = 10
# inner pair
@pytest.mark.cuda
@pytest.mark.parametrize("B,D,n,ny,nk2,tiles,bf16", [
    (5, 3, 37, 40, 9, (16, 2, 7, 4), False),
    (5, 3, 37, 40, 9, (4, 3, 21, 16), True),
    (3, 2, 24, 30, 5, (1, 1, 16, 4), False),
    (2, 2, 40, 26, 13, (16, 2, 6, 8), False),    # v-chunks of 8 (hy 12)
    (1, 1, 16, 16, 3, (8, 1, 9, 16), False),
    (4, 10, 32, 32, 9, None, False)])
def test_anchor_windows_tilings_on_card(cuda_device, monkeypatch, B, D, n,
                                        ny, nk2, tiles, bf16):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    X = torch.fft.rfft2(torch.randn(B, D, n, ny, device=cuda_device,
                                    generator=gen))
    taps = torch.randn(D, D, nk2, nk2, device=cuda_device, generator=gen) * .2
    h2, s1 = nk2 // 2, 1 / (4 * D)
    if tiles is not None:
        plan = wk.plan_of(True, B, D, D, n, ny // 2 + 1, h2, h2, False,
                          *tiles)
        monkeypatch.setattr(wk, "window_plan", lambda *_: plan)
    sd = torch.bfloat16 if bf16 else None
    got = _repeated(lambda: wk.anchor_windows(X, taps, n, ny, h2, h2, s1,
                                              signal_dtype=sd))
    want = wk.anchor_windows_plain(X, taps, n, ny, h2, h2, s1,
                                   signal_dtype=sd)
    for name, g, w in zip(("XX", "EGw", "seg", "e0"), got, want):
        assert rel(g.cpu(), w.cpu()) < CARD_TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,E,n,ny,h,same,tiles", [
    (5, 3, 3, 37, 40, 8, True, (16, 2, 7, 4)),
    (5, 3, 6, 37, 40, 4, False, (4, 3, 21, 16)),
    (2, 2, 3, 24, 30, 12, False, (8, 1, 16, 4)),  # v-chunks of 8
    (3, 1, 1, 16, 18, 2, True, (32, 3, 10, 2)),
    (2, 10, 20, 16, 16, 4, False, None)])         # 200 pairs, few rows
def test_corr_pair_windows_tilings_on_card(cuda_device, monkeypatch, B, D, E,
                                           n, ny, h, same, tiles):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    X = torch.fft.rfft2(torch.randn(B, D, n, ny, device=cuda_device,
                                    generator=gen))
    Z = X if same else torch.fft.rfft2(torch.randn(
        B, E, n, ny, device=cuda_device, generator=gen))
    if tiles is not None:
        plan = wk.plan_of(False, B, D, E, n, ny // 2 + 1, h, h, same, *tiles)
        monkeypatch.setattr(wk, "window_plan", lambda *_: plan)
    got = _repeated(lambda: wk.corr_pair_windows(X, Z, n, ny, h, h))
    want = wk.corr_pair_windows_plain(X, Z, n, ny, h, h)
    assert rel(got.cpu(), want.cpu()) < CARD_TOL


@pytest.mark.cuda
def test_window_kernels_refuse_a_plan_of_other_shared_memory(cuda_device,
                                                             monkeypatch):
    """The C entry point recomputes the plan's layout and refuses a plan
    whose shared memory differs from its own."""
    X = torch.fft.rfft2(torch.randn(1, 2, 16, 16, device=cuda_device))
    plan = wk.window_plan(False, 1, 2, 2, 16, 9, 2, 2, True)
    monkeypatch.setattr(wk, "window_plan",
                        lambda *_: plan._replace(smem=plan.smem + 16))
    with pytest.raises(RuntimeError, match="cudaError"):
        wk.corr_pair_windows(X, X, 16, 16, 2, 2)


# ------------------------------------------------------ the launch plan

WINDOW_SHAPES = [  # (B, n): pair 0's input at 256^2, 1024^2, 2048^2 frames
    (8, 128), (4, 512), (1, 1024)]


def _plans(B, n):
    """K3's two launches of one precompute and K4's, default net (D = 3,
    composed 9x9 taps)."""
    nyr = n // 2 + 1
    return {"k3 xx": (False, B, 3, 3, n, nyr, 8, 8, True),
            "k3 eg": (False, B, 3, 6, n, nyr, 4, 4, False),
            "k4": (True, B, 3, 3, n, nyr, 4, 4, False)}


def _covers(plan, B, nx, nyr):
    """Every row, batch and ω_y bin in exactly one block, every bin of a
    chunk in one step of its walk."""
    tiles, groups, chunks = plan.grid
    assert (tiles - 1) * plan.rows < nx <= tiles * plan.rows
    assert (groups - 1) * plan.batches < B <= groups * plan.batches
    assert (chunks - 1) * plan.ychunk < nyr <= chunks * plan.ychunk
    steps = -(-plan.ychunk // plan.ytile)
    assert (steps - 1) * plan.ytile < plan.ychunk <= steps * plan.ytile


@pytest.mark.parametrize("B,n", WINDOW_SHAPES)
@pytest.mark.parametrize("which", ["k3 xx", "k3 eg", "k4"])
def test_window_plan_covers_every_bin_and_fills_the_card(B, n, which):
    args = _plans(B, n)[which]
    plan = wk.window_plan(*args)
    _covers(plan, B, n, n // 2 + 1)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= wk.NUM_SMS
    assert plan.smem <= 232448
    assert plan.threads % 32 == 0 and plan.threads <= 512
    assert plan == wk.plan_of(*args, plan.rows, plan.batches, plan.ychunk,
                              plan.ytile)


@pytest.mark.parametrize("which,n", [("k4", 4096), ("k4", 8192),
                                     ("k3 xx", 8192)])
def test_window_plan_chunks_a_row_past_shared_memory(which, n):
    """8192^2 frames and up: pair 0's row of n/2 + 1 bins does not fit one
    block's shared memory with its bases (K4: 128 bytes a bin, K3 at ±8:
    80), so ω_y is chunked although the rows alone fill the card."""
    args = _plans(1, n)[which]
    plan = wk.window_plan(*args)
    _covers(plan, 1, n, n // 2 + 1)
    assert plan.grid[2] >= 2 and plan.smem <= 232448
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= wk.NUM_SMS
    with pytest.raises(ValueError, match="cannot run"):
        wk.plan_of(*args, plan.rows, plan.batches, n // 2 + 1, plan.ytile)


@pytest.mark.parametrize("args", [
    (True, 2, 10, 10, 32, 17, 4, 4, False),     # an inner pair, D = 10
    (False, 1, 10, 20, 64, 33, 4, 4, False),    # 200 pairs
    (True, 1, 3, 3, 40, 14, 6, 6, False),       # 13x13 taps: v-chunks
    (False, 3, 1, 1, 5, 4, 0, 0, True)])        # a window of one lag
def test_window_plan_other_shapes(args):
    plan = wk.window_plan(*args)
    _covers(plan, args[1], args[4], args[5])
    assert plan.threads <= 512 and plan.smem <= 232448


def test_window_plan_refuses_too_many_pairs_for_a_row():
    with pytest.raises(ValueError, match="threads for one x-row"):
        wk.window_plan(True, 1, 20, 20, 64, 33, 4, 4)


@pytest.mark.parametrize("nx,ny,h", [(128, 128, 4), (512, 512, 4),
                                     (1024, 1024, 4), (40, 26, 6),
                                     (16, 19, 2)])
def test_lag_basis_of_half_extent_is_the_centre_of_the_double(nx, ny, h):
    """K4 stages one lag basis: the ±h bases are the centre 2h+1 columns of
    the ±2h ones, bit for bit."""
    from spectralae_torch.ops import dft
    half = dft.lag_basis(nx, ny, h, h)
    full = dft.lag_basis(nx, ny, 2 * h, 2 * h)
    for a, b in zip(half, full):
        assert np.array_equal(a, b[:, h:3 * h + 1])


def _fold_windows(P, ybas, xbas, hx, hy):
    """csrc/corr_windows.cu's transform, in float64 from its packed bases:
    four sums per (pair, u >= 0, v >= 0), then the four quadrants."""
    c, s = ybas[:, 0:2 * hy + 2:2], ybas[:, 1:2 * hy + 2:2]
    cx, sx = xbas[:, 0:2 * hx + 2:2], xbas[:, 1:2 * hx + 2:2]
    sums = [np.einsum("qxy,yv->qxv", a, b) for a, b in
            ((P.real, c), (P.imag, s), (P.real, s), (P.imag, c))]
    a1, a2 = (np.einsum("xu,qxv->quv", cx, t) for t in sums[:2])
    a3, a4 = np.einsum("xu,qxv->quv", sx, sums[3]), \
        np.einsum("xu,qxv->quv", sx, sums[2])
    W = np.zeros((P.shape[0], 2 * hx + 1, 2 * hy + 1))
    for u in range(hx + 1):
        for v in range(hy + 1):
            dm, dp = a1[:, u, v] - a2[:, u, v], a1[:, u, v] + a2[:, u, v]
            sp, sm = a3[:, u, v] + a4[:, u, v], a3[:, u, v] - a4[:, u, v]
            W[:, hx + u, hy + v], W[:, hx + u, hy - v] = dm - sp, dp - sm
            W[:, hx - u, hy + v], W[:, hx - u, hy - v] = dm + sp, dp + sm
    return W


@pytest.mark.parametrize("B,D,E,nx,ny,hx,hy", [
    (2, 3, 3, 32, 32, 4, 4), (1, 2, 3, 24, 16, 3, 2), (2, 2, 2, 16, 19, 2, 3),
    (1, 2, 2, 16, 40, 3, 12)])
def test_k3_fold_of_the_lags_from_the_packed_bases(B, D, E, nx, ny, hx, hy):
    """The kernels' transform (the ±v, ±u fold) on K3's packed constants
    equals the plain windows."""
    rng = np.random.default_rng(nx + ny)
    nyr = ny // 2 + 1
    X, Z = rand_spec(rng, B, D, nx, nyr), rand_spec(rng, B, E, nx, nyr)
    flat = wk._consts_on("pair", nx, ny, hx, hy, torch.device("cpu")).numpy()
    nvt = wk._cols_per_thread(hy)
    ys = wk._round4(2 * -(-(hy + 1) // nvt) * nvt)
    ybas = flat[:nyr * ys].reshape(nyr, ys)
    xbas = flat[nyr * ys:].reshape(nx, -1)
    P = np.mean(np.conj(X)[:, :, None] * Z[:, None], axis=0).reshape(
        D * E, nx, nyr)
    got = _fold_windows(P, ybas.astype(np.float64), xbas.astype(np.float64),
                        hx, hy)
    want = wk.corr_pair_windows_plain(_t(X), _t(Z), nx, ny, hx, hy)
    assert rel(got.reshape(want.shape), want) < TOL


def test_window_bench_reads_registers_and_spills():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_windows_bench.py"
    spec = importlib.util.spec_from_file_location("torch_windows_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    k = "_ZN12_GLOBAL__N_118window_rows_kernelILi9ELi5ELb1ELb0EEEvNS_4ArgsE"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{k}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'",
        "ptxas info    : Used 8 registers"])
    assert mod.ptxas_report(log) == {k: {"stack": 0, "spill": 0,
                                         "regs": 90}}


def test_window_bench_needs_a_card(monkeypatch, capsys):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_windows_bench.py"
    spec = importlib.util.spec_from_file_location("torch_windows_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(["--check"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
