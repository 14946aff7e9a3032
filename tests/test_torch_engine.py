"""The port's interactive Engine against the JAX package's (CPU).

Both engines carry the same weights (the JAX engine's, moved across as numpy
with ``params_from_numpy``) and see the same frames and keys:

- ``step`` in both domains: the reconstruction at norm-relative 1e-5
  (float32 FFTs of two libraries, or convolutions summed in another order);
  the view images equal JAX's except where a float32 difference moves a
  value across a rounding or truncation boundary: at most one count, on at
  most 1 % of the pixels (measured: none differ).
- fft training disarms after one burst (the ω-space burst on the CPU, as
  the JAX package off its accelerator): weights and the last mse at 1e-5
  after 5 iterations (the burst's float32 FFT gradients through two
  libraries; measured 3e-8 and 1e-7).
- coordinate training stays armed; over 3 frames the weights, momentum and
  the printed mse match JAX's at 1e-5 (measured ≤ 5e-7), with the '0',
  '9' and 'p' variants.
- every key dispatches, the non-random ones return JAX's values, key
  mashing survives, ``info()`` is JAX's text; ``.conv`` files are
  byte-identical to JAX's and load in either package; the full checkpoint
  round-trips.

The test marked ``cuda`` runs an engine on the card against one on the CPU;
JAX is imported inside the tests that compare with it, so that it runs
where JAX is not installed::

    python -m pytest tests/test_torch_engine.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.core.config import Config, LayerParams
from spectralae_torch.core.types import params_from_numpy
from spectralae_torch.model.engine import KEYMAP, Engine, dispatch_key

torch.set_num_threads(1)

TOL = 1e-5
# the card's correlation-space burst against the CPU's ω-space one, 10
# iterations: chip_smoke.py's stream tolerance for the weights
BURST_TOL = 1e-4


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _layer(m):
    return dict(depth=m, lk=0, ll=0, scale=2, rmax=0.5)


def make_engine(nx=16, m=4, fft_iters=5, device="cpu", **kw):
    cfg = Config(nx=nx, ny=nx, d=3, layer=LayerParams(**_layer(m)),
                 fft_iters=fft_iters)
    return Engine(cfg, seed=0, device=device, **kw)


def jax_engine(nx=16, m=4, fft_iters=5):
    from spectralae.core.config import Config as JConfig
    from spectralae.core.config import LayerParams as JLayer
    from spectralae.model.engine import Engine as JEngine
    cfg = JConfig(nx=nx, ny=nx, d=3, layer=JLayer(**_layer(m)),
                  fft_iters=fft_iters)
    return JEngine(cfg, seed=0)


def carry(jeng, teng) -> None:
    """Give the port's engine the JAX engine's weights and structure."""
    teng.spec = jeng.spec
    teng.params = params_from_numpy(
        [(np.asarray(s.c), np.asarray(s.b)) for s in jeng.params.stages],
        device=teng.device)
    teng.flags.n_l = jeng.flags.n_l
    teng._reset_pair_opt_state()


def pair_engines(nx=16, m=4, layers=1, fft_iters=5):
    jeng, teng = jax_engine(nx, m, fft_iters), make_engine(nx, m, fft_iters)
    for _ in range(layers - 1):
        jeng.add_layer()
    jeng.select_layer(0)
    carry(jeng, teng)
    return jeng, teng


def frame(nx=16, seed=0, d=3):
    rng = np.random.default_rng(seed)
    return rng.normal(100, 40, size=(d, nx, nx)).astype(np.float32)


def assert_views_match(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        g = np.asarray(got[k]).astype(np.int64)
        w = np.asarray(want[k]).astype(np.int64)
        assert g.shape == w.shape, k
        diff = np.abs(g - w)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, k


def assert_pair_matches(jeng, teng, tol=TOL, mom=True) -> None:
    n_l = jeng.flags.n_l
    for g, w in zip(teng.params.pair(n_l), jeng.params.pair(n_l)):
        assert rel(g.c, np.asarray(w.c)) < tol
        assert rel(g.b, np.asarray(w.b)) < tol
    if mom:
        for g, w in zip(teng._mom, jeng._mom):
            if np.linalg.norm(np.asarray(w)) > 0:   # sym leaves Df zero
                assert rel(g, np.asarray(w)) < tol
    assert rel(teng.last_mse, jeng.last_mse) < tol


@pytest.mark.parametrize("layers", [1, 2])
def test_step_and_views_match_jax_in_both_domains(layers):
    jeng, teng = pair_engines(nx=32, layers=layers)
    for domain in ("fft", "coord"):
        if domain == "coord":
            dispatch_key(jeng, "f")
            dispatch_key(teng, "f")
        x = frame(32, seed=layers)
        got, want = teng.step(x), jeng.step(x)
        assert got.shape == (3, 32, 32) and got.dtype == np.float32
        assert rel(got, want) < TOL, domain
        assert_views_match(teng.current_views(), jeng.current_views())


def test_fft_layer_views_and_spectrum_match_jax():
    """'g' (fft_l) computes the tape every frame and adds the per-layer
    streams and the output spectrum (fft_backproplib.cu:1344-1361)."""
    jeng, teng = pair_engines(nx=16, layers=2)
    teng.step(frame())
    assert teng.layers is None          # fast path: no viz tax per frame
    for eng in (jeng, teng):
        dispatch_key(eng, "g")
        dispatch_key(eng, "q")
    x = frame(seed=3)
    teng.step(x)
    jeng.step(x)
    assert teng.layers is not None
    views = teng.current_views()
    for i in range(2 * teng.params.n_stages + 1):
        assert f"layer_{i}" in views
    assert views["spectrum"].shape == (16, 16)
    assert_views_match(views, jeng.current_views())


def test_fft_training_disarms_after_one_burst_and_matches_jax():
    jeng, teng = pair_engines()
    for eng in (jeng, teng):
        dispatch_key(eng, "1")
        eng.step(frame())
        assert not eng.flags.sel            # one burst per arm
    assert np.isfinite(teng.last_mse)
    assert_pair_matches(jeng, teng, mom=False)


@pytest.mark.parametrize("keys", ["", "0", "9", "p"],
                         ids=["gpu", "gpu_off", "active", "sym"])
def test_coord_training_stays_armed_and_matches_jax(keys):
    """'f' then '1': one reference coord step per frame, armed throughout;
    '0' takes the CPU reference's window (alpha 0), '9' the adaptive lr,
    'p' the tied weights."""
    jeng, teng = pair_engines(nx=16, layers=2)
    for eng in (jeng, teng):
        for k in keys + "f1":
            dispatch_key(eng, k)
    for i in range(3):
        x = frame(seed=i)
        teng.step(x)
        jeng.step(x)
        assert teng.flags.sel
        assert_pair_matches(jeng, teng)
    if "p" in keys:
        enc, dec = teng.params.pair(0)
        assert torch.equal(dec.c, enc.c.transpose(0, 1))


def test_fft_with_gpu_off_routes_to_coord_step_and_matches_jax():
    """gpu==0 sends fft training to the coordinate step at alpha 0 and
    stays armed (autoencoder.cpp:182-200); the tensors stay where they
    were."""
    jeng, teng = pair_engines()
    for eng in (jeng, teng):
        dispatch_key(eng, "0")
        dispatch_key(eng, "1")
    for i in range(2):
        x = frame(seed=i)
        teng.step(x)
        jeng.step(x)
        assert teng.flags.sel and teng.flags.fft
        assert_pair_matches(jeng, teng)
    assert teng.params.stages[0].c.device.type == "cpu"


def test_inner_pair_trains_at_its_resolution():
    jeng, teng = pair_engines(nx=32, layers=2)
    for eng in (jeng, teng):
        eng.select_layer(1)
        dispatch_key(eng, "1")
        eng.step(frame(32))
    assert_pair_matches(jeng, teng, mom=False)
    outer = make_engine(nx=32)
    carry(jeng, outer)
    assert torch.equal(teng.params.stages[0].c, outer.params.stages[0].c)


def test_keys_return_jax_values(tmp_path, monkeypatch):
    """Every key but the random draws ('e', 'n': each package its own
    generator) returns what JAX's engine returns, in one sequence."""
    monkeypatch.chdir(tmp_path)
    jeng, teng = pair_engines(nx=32, layers=2)
    x = frame(32)
    jeng.step(x)
    teng.step(x)
    for key in "2234455567769qwwmgzxzcpdsliz3":
        got, want = dispatch_key(teng, key), dispatch_key(jeng, key)
        if key == "s":
            got, want = [p.name for p in got], [p.name for p in want]
        assert got == want, key
    assert dispatch_key(teng, "?") is None


def test_info_equals_jax_text():
    jeng, teng = pair_engines(nx=32, layers=3)
    assert teng.info() == jeng.info()
    assert teng.spec == jeng.spec


def test_all_keys_dispatch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    eng = make_engine(nx=16)
    eng.step(frame())
    for key in KEYMAP:
        if key == "l":
            dispatch_key(eng, "s")  # ensure files exist before load
        dispatch_key(eng, key)
    assert eng.step(frame()).shape == (3, 16, 16)
    assert len(KEYMAP) == 24


def test_engine_survives_random_key_mashing(tmp_path, monkeypatch):
    """120 random key presses interleaved with steps never crash the engine
    (failed commands raise the documented ValueError/OSError only) and
    leave it steppable."""
    import random
    monkeypatch.chdir(tmp_path)  # 's' writes ./weights here
    rng = random.Random(0)
    eng = Engine(Config(nx=16, ny=16, d=2, layer=LayerParams(**_layer(4))),
                 device="cpu")
    keys = list(KEYMAP)
    x = np.zeros((2, 16, 16), np.float32) + 7.0
    for i in range(120):
        try:
            dispatch_key(eng, rng.choice(keys))
        except (ValueError, OSError):
            pass  # documented failure modes (bad load, non-divisible 'n')
        if i % 10 == 0:
            assert np.isfinite(eng.step(x)).all()
            eng.current_views()
    assert eng.step(x).shape == (2, 16, 16)


def test_layer_mutation_roundtrip():
    eng = make_engine(nx=32)
    assert eng.spec.n_pairs == 1
    assert dispatch_key(eng, "n") == 2 and eng.flags.n_l == 1
    assert eng.step(frame(32)).shape == (3, 32, 32)
    assert dispatch_key(eng, "d") == 1 and eng.flags.n_l == 0
    assert eng.step(frame(32)).shape == (3, 32, 32)
    assert dispatch_key(eng, "d") == 1     # cannot drop below one pair


def test_direct_selection_between_same_shape_pairs_resets_opt_state():
    eng = make_engine(nx=64)
    eng.add_layer()
    eng.add_layer()              # pairs 1 and 2: same inner kernel shapes
    eng.select_layer(1)
    eng.toggle_fft()
    eng.toggle_training()
    eng.step(frame(64))
    assert any(float(t.abs().sum()) > 0 for t in eng._mom)
    eng.flags.n_l = 2            # direct assignment, bypasses select_layer
    eng.step(frame(64))
    assert eng._mom_pair == 2    # state was re-zeroed for pair 2's step


def test_same_seed_and_keys_give_the_same_weights():
    """'e' and 'n' draw from the engine's CPU generator: two engines with
    one seed and one key sequence hold the same weights."""
    a, b = make_engine(nx=32), make_engine(nx=32)
    for eng in (a, b):
        for k in "nezen":
            dispatch_key(eng, k)
    assert a.spec.n_pairs == b.spec.n_pairs == 3
    for x, y in zip(a.params.leaves(), b.params.leaves()):
        assert torch.equal(x, y)


def test_param_file_reload(tmp_path):
    from spectralae_torch.core.config import save_layer_params
    pf = tmp_path / "New_Layer_Param.txt"
    save_layer_params(LayerParams(depth=6, lk=1, ll=1, scale=2, rmax=2.0),
                      pf)
    eng = Engine(Config(nx=32, ny=32, d=3), seed=0, param_file=pf,
                 device="cpu")
    assert eng.params.stages[0].m == 6 and eng.params.stages[0].nk == 5
    eng.add_layer()
    assert eng.params.stages[1].m == 6
    assert float(eng.params.stages[1].c.abs().max()) <= 2.0


def test_conv_files_are_jax_bytes_and_cross_load(tmp_path):
    from spectralae.io import checkpoint as jckpt
    jeng, teng = pair_engines(nx=32, layers=2)
    for eng in (jeng, teng):
        eng.select_layer(1)
    tp = teng.save_weights(tmp_path / "torch")
    jp = jeng.save_weights(tmp_path / "jax")
    assert [p.name for p in tp] == [p.name for p in jp]
    for a, b in zip(tp, jp):
        assert a.read_bytes() == b.read_bytes()
    # the port reads JAX's files and JAX reads the port's
    fresh = make_engine(nx=32)
    fresh.add_layer()
    fresh.load_weights(tmp_path / "jax")
    for g, w in zip(fresh.params.pair(1), jeng.params.pair(1)):
        np.testing.assert_array_equal(g.c.numpy(), np.asarray(w.c))
        np.testing.assert_array_equal(g.b.numpy(), np.asarray(w.b))
    back = jckpt.load_pair_conv(jeng.params, jeng.spec, 1, tmp_path / "torch")
    for g, w in zip(back.pair(1), teng.params.pair(1)):
        np.testing.assert_array_equal(np.asarray(g.c), w.c.numpy())


def test_conv_import_refuses_a_wrong_float_count(tmp_path):
    from spectralae_torch.io import checkpoint as ckpt
    p = tmp_path / "bad.conv"
    np.arange(7, dtype="<f4").tofile(p)
    with pytest.raises(ValueError, match="expected"):
        ckpt.import_conv(p, 2, 1, 1, 1)


def test_save_load_weights_and_missing_file(tmp_path):
    eng = make_engine()
    eng.save_weights(tmp_path)
    old = eng.params.stages[0].c.clone()
    eng.reinit_weights()
    assert not torch.equal(eng.params.stages[0].c, old)
    eng.load_weights(tmp_path)
    assert torch.equal(eng.params.stages[0].c, old)
    with pytest.raises(OSError):
        eng.load_weights(tmp_path / "missing")


def test_engine_full_checkpoint_roundtrip(tmp_path):
    eng = make_engine(nx=32)
    eng.add_layer()
    eng.step(frame(32))
    eng.save_checkpoint(tmp_path / "full")
    want = eng.params.stages[1].c.clone()
    eng2 = make_engine(nx=32)
    eng2.load_checkpoint(tmp_path / "full")
    assert eng2.spec.n_pairs == 2 and eng2.step_count == 1
    assert torch.equal(eng2.params.stages[1].c, want)
    assert eng2.step(frame(32)).shape == (3, 32, 32)


def test_cuda_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        make_engine(device="cuda")


def pair_mse64(x, c, f, b, p):
    """The stage pair's reconstruction mse of ``x`` (the fft burst's own
    measure: the pool-free two-stage spectral conv, Parseval-normalized),
    recomputed in float64 on the CPU."""
    from spectralae_torch.ops import spectral
    x, c, f, b, p = (t.detach().cpu().double() for t in (x, c, f, b, p))
    nx, ny = x.shape[-2:]
    X = spectral.rfft2(x)
    H = spectral.spectral_conv_einsum(
        X[None], spectral.rfft2(spectral.kernel_pad(c, nx, ny)), b, nx, ny)
    O = spectral.spectral_conv_einsum(
        H, spectral.rfft2(spectral.kernel_pad(f, nx, ny)), p, nx, ny)[0]
    return float(spectral.parseval_mse(X, O, c.shape[1], c.shape[0], nx, ny))


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(monkeypatch):
    """The default net's widths at 64^2 (two pairs), the same seed and keys
    on the card and on the CPU, each frame started from the same state:
    K1 once a stage in a fft frame, K3 twice a burst (the correlation burst
    on the card, the ω-space one on the CPU: 10 iterations, where the two
    agree pointwise), K2 twice a coord frame.  The reconstruction and the
    activation tape at 1e-4 (fft: float32 FFTs of two libraries) and 1e-5
    (coord); the weights at 1e-4 after a burst, 1e-5 after a coord step
    (momentum 1e-4).  A burst's last mse is held as each burst's returned
    weights give it, recomputed in float64, at 1e-4 (chip_smoke.py
    TOL_STREAM_MSE): the correlation burst's own running mse is summed
    from terms anchored on its first mse, which float32 cancellation
    leaves some epsilons of that anchor off.  cuDNN's TF32 stays at
    PyTorch's default (on): the engine's library convs run in IEEE float32
    by themselves."""
    from spectralae_torch.model import engine as engine_mod
    from spectralae_torch.ops import spectral_kernels as sk
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    bursts = {}
    burst = engine_mod.auto_burst

    def recorded_burst(x, *a, **kw):
        r = burst(x, *a, **kw)
        bursts[x.device.type] = pair_mse64(x, r.c, r.f, r.b, r.p)
        return r
    monkeypatch.setattr(engine_mod, "auto_burst", recorded_burst)
    cfg = Config(nx=64, ny=64, fft_iters=10)
    card = Engine(cfg, seed=0, device="cuda")
    cpu = Engine(cfg, seed=0, device="cpu")
    for eng in (card, cpu):
        eng.add_layer()
        eng.select_layer(eng.spec.n_pairs - 1)
    rng = np.random.default_rng(0)
    for keys in ("1", "", "f1", "", ""):
        for eng in (card, cpu):
            for k in keys:
                dispatch_key(eng, k)
        cpu.params = type(card.params).from_leaves(
            [t.cpu() for t in card.params.leaves()])
        cpu._mom = tuple(t.cpu() for t in card._mom)
        cpu._prev_grad = tuple(t.cpu() for t in card._prev_grad)
        x = rng.uniform(0, 255, size=(3, 64, 64)).astype(np.float32)
        before = (sk.k1_launches(), _kernels.LAUNCHES["conv_valid"],
                  _kernels.LAUNCHES["corr_pair_windows"])
        trains, fft = card.flags.sel, card.flags.fft
        out = (card.step(x), cpu.step(x))
        grew = (sk.k1_launches() - before[0],
                _kernels.LAUNCHES["conv_valid"] - before[1],
                _kernels.LAUNCHES["corr_pair_windows"] - before[2])
        stages = card.params.n_stages
        assert grew == ((stages, 0, 2 if trains else 0) if fft
                        else (0, 2, 0))
        tape_tol = BURST_TOL if fft else TOL
        assert rel(*out) < tape_tol
        if card.layers is not None:
            for g, w in zip(card.layers, cpu.layers):
                assert rel(g.cpu(), w) < tape_tol
        if not trains:
            continue
        tol = BURST_TOL if fft else TOL
        for g, w in zip(card.params.leaves(), cpu.params.leaves()):
            assert rel(g.cpu(), w) < tol
        if fft:
            assert rel(bursts["cuda"], bursts["cpu"]) < BURST_TOL
        else:
            assert rel(card.last_mse, cpu.last_mse) < TOL
            for g, w in zip(card._mom, cpu._mom):
                assert rel(g.cpu(), w) < 1e-4
