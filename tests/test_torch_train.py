"""The port's training slice against the JAX package (CPU).

- The kernels' autograd Functions (``SpectralConvFused``, ``ConvValid``)
  against the JAX package's custom VJPs, run as its own tests run them (the
  Pallas kernels in interpret mode), and against autograd through the
  plain path.  The Functions run their kernels' plain versions here.
- ``train_step`` against JAX's over three steps in both domains, with the
  ``train_pair`` mask, ``accum_steps``, ``remat`` and ``active``.
- The ``train`` CLI on the CPU, with checkpoints, rotation, async saves and
  resume, and checkpoints that cross between the two packages.

Tolerances, norm-relative unless stated: the Functions' gradients 1e-4
relative with an absolute floor of 1e-6 against the VJPs (float32 FFTs from
two libraries on the way in and out), 1e-5 against autograd through the
plain path; three train steps 1e-5 for parameters, momentum, raw gradients
and losses (float32 FFT and conv chains through two libraries).  Measured
when this file was written: at most 2.5e-6 (fft) and 2.1e-6 (coord) over
the three steps, the raw gradients at most 1.1e-6.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spectralae.core import types as jtypes
from spectralae.core.config import Config, LayerParams
from spectralae.ops import dft as jdft
from spectralae.ops import pallas_conv as jpc
from spectralae.ops import pallas_kernels as jpk
from spectralae.train import modern as jmodern
from spectralae_torch.cli.main import main as tcli
from spectralae_torch.core import types as ttypes
from spectralae_torch.io import checkpoint as tckpt
from spectralae_torch.model import autoencoder as tmodel
from spectralae_torch.ops import coord as tcoord
from spectralae_torch.ops import coord_kernels as ck
from spectralae_torch.ops import dft as tdft
from spectralae_torch.ops import spectral as tspec
from spectralae_torch.ops import spectral_kernels as sk
from spectralae_torch.train import modern as tmodern

torch.set_num_threads(1)

VJP_RTOL, VJP_ATOL = 1e-4, 1e-6
PLAIN_TOL = 1e-5
STEP_TOL = 1e-5


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def flat(params) -> np.ndarray:
    """Every parameter of a port or JAX ``AEParams``, in one vector."""
    return np.concatenate([np.asarray(t).ravel() for st in params.stages
                           for t in (st.c, st.b)])


# ------------------------------------------------ the kernels' Functions

def _spectral_problem(seed, nx=16, ny=16, nb=2, d=3, m=5):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(nb, d, nx, ny)).astype(np.float32)
    c = rng.normal(size=(m, d, 3, 3)).astype(np.float32)
    b = rng.normal(size=m).astype(np.float32)
    target = rng.normal(size=(nb, m, nx, ny)).astype(np.float32)
    return xs, c, b, target


@pytest.mark.parametrize("scale_by_dm", [True, False])
def test_spectral_conv_fused_grads_match_jax_vjp(scale_by_dm):
    """Gradients with respect to the real frames, kernels and biases, taken
    through rfft2 → kernel spectra → the Function → irfft2."""
    nx = ny = 16
    xs, c, b, target = _spectral_problem(0)

    def jloss(x, cc, bb):
        X = jnp.fft.rfft2(x)
        C = jdft.kernel_spectrum(cc, nx, ny)
        y = jnp.fft.irfft2(jpk.spectral_conv_fused(X, C, bb, nx, ny,
                                                   scale_by_dm), s=(nx, ny))
        return jnp.mean((y - target) ** 2)

    def tloss(conv, x, cc, bb):
        X = torch.fft.rfft2(x)
        C = tdft.kernel_spectrum(cc, nx, ny)
        y = torch.fft.irfft2(conv(X, C, bb), s=(nx, ny))
        return torch.mean((y - torch.from_numpy(target)) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(xs), jnp.asarray(c), jnp.asarray(b))
    grads = {}
    for name, conv in (
            ("fused", lambda X, C, bb: sk.spectral_conv_fused(
                X, C, bb, nx, ny, scale_by_dm)),
            ("plain", lambda X, C, bb: tspec.spectral_conv_einsum(
                X, C, bb, nx, ny, scale_by_dm=scale_by_dm))):
        leaves = [torch.tensor(a, requires_grad=True) for a in (xs, c, b)]
        tloss(conv, *leaves).backward()
        grads[name] = [t.grad.numpy() for t in leaves]
    for got, plain, w in zip(grads["fused"], grads["plain"], want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=VJP_RTOL,
                                   atol=VJP_ATOL)
        assert rel(got, plain) < PLAIN_TOL


def test_spectral_conv_fused_backward_contracts_only_what_is_needed(
        monkeypatch):
    """With input spectra that need no gradient (stage 0 of a net) the
    backward runs one contraction, for the kernel spectra; with both, two —
    each with ``q`` conjugated."""
    calls = []
    real = sk.cmul_contract

    def counting(p, q, **kw):
        calls.append(kw.get("conj_q", False))
        return real(p, q, **kw)
    monkeypatch.setattr(sk, "cmul_contract", counting)
    xs, c, b, _ = _spectral_problem(1)
    X = torch.fft.rfft2(torch.from_numpy(xs))
    ct = torch.tensor(c, requires_grad=True)
    bb = torch.tensor(b, requires_grad=True)
    for x_grad, want in ((False, [False, True]), (True, [False, True, True])):
        calls.clear()
        C = tdft.kernel_spectrum(ct, 16, 16)
        Xs = X.clone().requires_grad_(x_grad)
        sk.spectral_conv_fused(Xs, C, bb, 16, 16).abs().sum().backward()
        assert calls == want


def test_cmul_contract_conj_and_strided_p_match_numpy():
    rng = np.random.default_rng(2)
    p = (rng.normal(size=(4, 3, 9)) + 1j * rng.normal(size=(4, 3, 9))
         ).astype(np.complex64)
    q = (rng.normal(size=(4, 5, 9)) + 1j * rng.normal(size=(4, 5, 9))
         ).astype(np.complex64)
    pt = torch.from_numpy(p).transpose(0, 1)     # [3, 4, 9] view
    got = sk.cmul_contract(pt, torch.from_numpy(q), p_scale=0.5,
                           conj_q=True).numpy()
    want = np.einsum("kaw,kbw->abw", p.astype(np.complex128) * 0.5,
                     np.conj(q))
    assert np.linalg.norm(got - want) < 1e-6 * np.linalg.norm(want)


def _conv_problem(seed, b=2, d=3, m=4, h=12, w=10, nk=5, nl=5):
    rng = np.random.default_rng(seed)
    xpad = rng.normal(size=(b, d, h + nk - 1, w + nl - 1)).astype(np.float32)
    wt = rng.normal(size=(m, d, nk, nl)).astype(np.float32)
    dy = rng.normal(size=(b, m, h, w)).astype(np.float32)
    return xpad, wt, dy


@pytest.mark.parametrize("data_grad_kernel", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 4, 12, 10, 5, 5),
                                   (1, 4, 3, 9, 11, 3, 5)])
def test_conv_valid_vjp_matches_jax(monkeypatch, data_grad_kernel, shape):
    """dx and dw of the Function against JAX's custom VJP, with the data
    grad routed the same way on both sides (``PALLAS_DATA_GRAD``)."""
    monkeypatch.setattr(jpc, "PALLAS_DATA_GRAD", data_grad_kernel)
    monkeypatch.setattr(ck, "PALLAS_DATA_GRAD", data_grad_kernel)
    xpad, wt, dy = _conv_problem(3, *shape)
    _, vjp = jax.vjp(lambda x, w: jpc.conv_valid_pallas(x, w, True),
                     jnp.asarray(xpad), jnp.asarray(wt))
    want = vjp(jnp.asarray(dy))
    xt = torch.tensor(xpad, requires_grad=True)
    w_t = torch.tensor(wt, requires_grad=True)
    ck.conv_valid(xt, w_t).backward(torch.from_numpy(dy))
    for got, w in zip((xt.grad, w_t.grad), want):
        assert got.shape == w.shape
        assert rel(got, w) < PLAIN_TOL


def test_conv_valid_data_grad_routes(monkeypatch):
    """The data grad takes the kernel's route only with the flag, and the
    weight grad never does; both routes agree."""
    calls = []
    real = ck._valid_corr

    def counting(xpad, w):
        calls.append(tuple(w.shape))
        return real(xpad, w)
    monkeypatch.setattr(ck, "_valid_corr", counting)
    xpad, wt, dy = _conv_problem(4)
    grads = []
    for flag in (False, True):
        monkeypatch.setattr(ck, "PALLAS_DATA_GRAD", flag)
        calls.clear()
        xt = torch.tensor(xpad, requires_grad=True)
        ck.conv_valid(xt, torch.from_numpy(wt)).backward(
            torch.from_numpy(dy))
        grads.append(xt.grad)
        assert calls == [(4, 3, 5, 5)] + ([(3, 4, 5, 5)] if flag else [])
    assert rel(grads[1], grads[0]) < PLAIN_TOL


# ------------------------------------------------------------ train_step

CFG = Config(nx=32, ny=32, d=3, layer=LayerParams(depth=4))


def _net(seed=0, pairs=2, batch=2, steps=3):
    spec = jtypes.initial_spec(CFG)
    for _ in range(pairs - 1):
        spec = spec.add_pair(CFG.layer)
    rng = np.random.default_rng(seed)
    arrays = [(rng.uniform(-1, 1, (s.m, s.d, s.nk, s.nl)).astype(np.float32),
               rng.uniform(-1, 1, s.m).astype(np.float32))
              for s in spec.stages]
    xs = [rng.uniform(0, 255, (batch, 3, 32, 32)).astype(np.float32)
          for _ in range(steps)]
    jp = jtypes.AEParams(stages=tuple(
        jtypes.ConvStage(c=jnp.asarray(c), b=jnp.asarray(b))
        for c, b in arrays))
    return jp, ttypes.params_from_numpy(arrays), spec, xs


def _run_both(domain, *, steps=3, **kw):
    """``steps`` train steps of each package from the same weights and
    frames; returns the worst norm-relative gap of parameters, momentum,
    raw gradient and loss over the steps, and the port's final result.
    The raw gradient is held on its own: the frames' 0-255 range puts most
    gradients above ``GRAD_CLIP``, where the update sees only their sign."""
    jp, tp, spec, xs = _net(steps=steps)
    jo, to = jtypes.init_opt_state(jp), ttypes.init_opt_state(tp)
    worst = 0.0
    for x in xs:
        jr = jmodern.train_step(jp, jo, jnp.asarray(x), spec.scales,
                                domain=domain, **kw)
        tr = tmodern.train_step(tp, to, torch.from_numpy(x), spec.scales,
                                domain=domain, **kw)
        worst = max(worst, rel(flat(tr.params), flat(jr.params)),
                    rel(flat(tr.opt.mom), flat(jr.opt.mom)),
                    rel(flat(tr.opt.prev_grad), flat(jr.opt.prev_grad)),
                    abs(float(tr.loss) / float(jr.loss) - 1))
        jp, jo, tp, to = jr.params, jr.opt, tr.params, tr.opt
    return worst, tr


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_train_step_matches_jax_over_three_steps(domain):
    worst, res = _run_both(domain)
    assert worst < STEP_TOL, worst
    assert res.loss.dim() == 0 and torch.isfinite(res.loss)


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_active_train_step_matches_jax(domain):
    worst, _ = _run_both(domain, active=True, lr=0.1)
    assert worst < STEP_TOL, worst


def test_train_pair_masks_like_jax():
    worst, res = _run_both("fft", steps=1, train_pair=1)
    assert worst < STEP_TOL, worst
    _, tp, _, _ = _net()
    for i, (new, old) in enumerate(zip(res.params.stages, tp.stages)):
        moved = not torch.equal(new.c, old.c)
        assert moved == (i in (1, 2)), i


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_accum_steps_matches_full_batch_and_jax(domain):
    jp, tp, spec, xs = _net(batch=4, steps=1)
    x = xs[0]
    full = tmodern.train_step(tp, ttypes.init_opt_state(tp),
                              torch.from_numpy(x), spec.scales, domain=domain)
    acc = tmodern.train_step(tp, ttypes.init_opt_state(tp),
                             torch.from_numpy(x), spec.scales, domain=domain,
                             accum_steps=2)
    jacc = jmodern.train_step(jp, jtypes.init_opt_state(jp), jnp.asarray(x),
                              spec.scales, domain=domain, accum_steps=2)
    assert rel(flat(acc.params), flat(full.params)) < STEP_TOL
    assert rel(flat(acc.params), flat(jacc.params)) < STEP_TOL
    assert abs(float(acc.loss) / float(full.loss) - 1) < STEP_TOL
    with pytest.raises(ValueError, match="not divisible"):
        tmodern.train_step(tp, ttypes.init_opt_state(tp),
                           torch.from_numpy(x[:3]), spec.scales,
                           accum_steps=2)


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_remat_step_matches_plain(domain):
    _, tp, spec, xs = _net(steps=1)
    x = torch.from_numpy(xs[0])
    plain = tmodern.train_step(tp, ttypes.init_opt_state(tp), x, spec.scales,
                               domain=domain)
    remat = tmodern.train_step(tp, ttypes.init_opt_state(tp), x, spec.scales,
                               domain=domain, remat=True)
    assert rel(flat(remat.params), flat(plain.params)) < 1e-6
    assert float(remat.loss) == float(plain.loss)


def test_train_step_through_the_kernel_functions_matches_jax(monkeypatch):
    """The route the card takes — every spectral conv through
    ``SpectralConvFused``, every coord conv of a K2 shape through
    ``ConvValid`` — forced on the CPU, where the Functions run their plain
    versions, still matches JAX over three steps in both domains."""
    def fused(X, C, b, nx, ny, *, scale_by_dm=True, compute_dtype=None):
        return sk.spectral_conv_fused(X, C, b, nx, ny, scale_by_dm,
                                      compute_dtype)
    monkeypatch.setattr(tspec, "spectral_conv", fused)
    monkeypatch.setattr(tcoord, "_auto_conv_kernel",
                        lambda x, s: tcoord._kernel_shape(s))
    for domain in ("fft", "coord"):
        worst, _ = _run_both(domain)
        assert worst < STEP_TOL, (domain, worst)


def test_train_step_is_functional_and_rejects_bf16():
    """The step leaves its arguments as they were, in float32 and with bf16
    operands, and refuses a reduced type other than bf16."""
    _, tp, spec, xs = _net(steps=1)
    opt = ttypes.init_opt_state(tp)
    before = [t.clone() for t in tp.leaves() + opt.mom.leaves()]
    for cd in (None, torch.bfloat16):
        for domain in ("fft", "coord"):
            res = tmodern.train_step(tp, opt, torch.from_numpy(xs[0]),
                                     spec.scales, domain=domain,
                                     compute_dtype=cd)
            assert all(t.dtype == torch.float32
                       for t in res.params.leaves())
    for t, t0 in zip(tp.leaves() + opt.mom.leaves(), before):
        assert torch.equal(t, t0)
    with pytest.raises(NotImplementedError, match="bf16 operands only"):
        tmodern.train_step(tp, opt, torch.from_numpy(xs[0]), spec.scales,
                           compute_dtype=torch.float16)


# ------------------------------------------------------------------- CLI

def _records(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_cli_train_checkpoints_rotates_and_resumes(tmp_path, capsys):
    ck_dir = tmp_path / "ck"
    common = ["train", "--device", "cpu", "--nx", "16", "--layers", "2",
              "--batch", "2", "--log-every", "1", "--ckpt", str(ck_dir)]
    tcli(common + ["--steps", "5", "--ckpt-every", "2",
                   "--ckpt-history", "2", "--metrics",
                   str(tmp_path / "m.jsonl")])
    recs = _records(capsys.readouterr().out)
    assert [r["step"] for r in recs] == list(range(5))
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 5
    assert (ck_dir / "LATEST").read_text() == "step_00000005"
    kept = sorted(p.name for p in ck_dir.iterdir() if p.is_dir())
    assert kept == ["step_00000003", "step_00000005"]
    params, spec, opt, extra = tckpt.load(ck_dir)
    assert extra["step"] == 5 and opt is not None
    assert spec.n_pairs == 2 and spec.nx == 16

    tcli(common + ["--steps", "7", "--resume", str(ck_dir), "--ckpt-async",
                   "--ckpt-history", "0", "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 5" in out
    assert [r["step"] for r in _records(out)] == [5, 6]
    _, _, opt2, extra2 = tckpt.load(ck_dir)
    assert extra2["step"] == 7
    assert not np.array_equal(opt2.mom.stages[0].c.numpy(),
                              opt.mom.stages[0].c.numpy())


def test_cli_train_torch_optimizer_sidecar(tmp_path, capsys):
    ck_dir = tmp_path / "ck"
    common = ["train", "--device", "cpu", "--nx", "16", "--batch", "2",
              "--log-every", "1", "--optimizer", "adam", "--lr", "0.01",
              "--domain", "coord", "--ckpt", str(ck_dir)]
    tcli(common + ["--steps", "2"])
    state = tckpt.load_optim_state(ck_dir / tckpt.OPTIM_SIDECAR)
    assert state["count"] == 2
    assert tckpt.load(ck_dir)[2] is None     # no inertia state beside it
    tcli(common + ["--steps", "3", "--resume", str(ck_dir)])
    assert tckpt.load_optim_state(ck_dir / tckpt.OPTIM_SIDECAR)["count"] \
        == 3
    # a JAX optax sidecar is named and not read
    (ck_dir / tckpt.OPTIM_SIDECAR).unlink()
    (ck_dir / tckpt.OPTAX_SIDECAR).write_bytes(b"")
    capsys.readouterr()
    tcli(common + ["--steps", "4", "--resume", str(ck_dir)])
    assert "does not read" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--domain", "fft"],
    ["--domain", "coord"],
    ["--domain", "fft", "--optimizer", "adam", "--lr", "0.01"]],
    ids=["fft", "coord", "fft-adam"])
def test_cli_train_step_tied_and_diverse(tmp_path, capsys, argv):
    """``train --mode step --sym --maxdiff``: a falling loss, and each
    decoder stage's kernels in the checkpoint its encoder's transposed; a
    resumed run keeps the tie."""
    ck_dir = tmp_path / "ck"
    common = ["train", "--device", "cpu", "--nx", "16", "--layers", "2",
              "--batch", "2", "--log-every", "1", "--mode", "step",
              "--sym", "--maxdiff", "--ckpt", str(ck_dir)] + argv
    tcli(common + ["--steps", "4"])
    losses = [r["loss"] for r in _records(capsys.readouterr().out)]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    tcli(common + ["--steps", "5", "--resume", str(ck_dir)])
    params = tckpt.load(ck_dir)[0]
    for p in range(params.n_pairs):
        enc, dec = params.pair(p)
        assert torch.equal(dec.c, enc.c.transpose(0, 1))
        assert dec.c.is_contiguous()


@pytest.mark.parametrize("argv,match", [
    (["--mode", "stream", "--domain", "coord", "--train-pair", "7"],
     "out of range"),
    (["--mode", "stream", "--domain", "coord", "--pair-sweep", "frame"],
     "requires --train-pair all")])
def test_cli_train_refuses_what_is_not_ported(argv, match):
    """The coordinate stream's refusals (the fft trainers' are in
    test_torch_stream_cli.py); nothing of ``train`` is left unported."""
    with pytest.raises(SystemExit, match=match):
        tcli(["train", "--device", "cpu", "--steps", "1"] + argv)


def test_cli_train_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli(["train", "--nx", "16", "--steps", "1"])


def test_cli_train_trace_writes_a_profile(tmp_path):
    tcli(["train", "--device", "cpu", "--nx", "16", "--batch", "1",
          "--steps", "1", "--trace", str(tmp_path / "tr")])
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_training_checkpoint_crosses_packages(tmp_path, capsys, direction):
    """A checkpoint with the inertia optimizer's state, written by one
    package after two steps, resumes in the other: two more steps there
    equal two more steps in the writer, which resumes the same checkpoint."""
    from spectralae.cli.main import main as jcli
    first, second = (jcli, tcli) if direction == "jax_to_port" \
        else (tcli, jcli)
    common = ["train", "--nx", "16", "--layers", "2", "--batch", "2",
              "--log-every", "1"]

    def dev(cli):       # the port's CLI defaults to the card
        return ["--device", "cpu"] if cli is tcli else []
    ck0 = tmp_path / "ck0"
    first(common + dev(first) + ["--steps", "2", "--ckpt", str(ck0)])
    outs = {}
    for name, cli in (("writer", first), ("reader", second)):
        dest = tmp_path / name
        cli(common + dev(cli) + ["--steps", "4", "--resume", str(ck0),
                                 "--ckpt", str(dest)])
        outs[name] = tckpt.load(dest)
    capsys.readouterr()
    (wp, _, wo, wx), (rp, _, ro, rx) = outs["writer"], outs["reader"]
    assert wx["step"] == rx["step"] == 4
    assert rel(flat(rp), flat(wp)) < STEP_TOL
    assert rel(flat(ro.mom), flat(wo.mom)) < STEP_TOL
    assert rel(flat(ro.prev_grad), flat(wo.prev_grad)) < STEP_TOL


def test_training_after_an_inference_mode_forward():
    """The index maps and DFT bases cached on a device by the first forward
    at a shape are ordinary tensors even when that forward ran under
    ``torch.inference_mode()`` (as serving runs it), so a later train step
    at the same shape can save them for its backward.  40x40 is a shape no
    other test uses, so the caches are filled here first."""
    from spectralae_torch.core.config import Config as TConfig
    spec = ttypes.initial_spec(TConfig(nx=40, ny=40))
    params = ttypes.init_params(torch.Generator().manual_seed(0), spec, 1.0)
    x = torch.rand(1, 3, 40, 40) * 255
    with torch.inference_mode():
        tmodel.forward_fft(params, x, spec.scales)
    for domain in ("fft", "coord"):
        res = tmodern.train_step(params, ttypes.init_opt_state(params), x,
                                 spec.scales, domain=domain)
        assert torch.isfinite(res.loss)
