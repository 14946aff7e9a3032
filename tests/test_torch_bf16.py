"""Mixed precision in the port (``compute_dtype=torch.bfloat16``) against
the JAX package's bf16 paths (CPU), and K1's bf16 mode on the card.

- The spectral conv with bf16 operands, the fused Function (K1's plain
  version here) and the einsum, against JAX's fused conv (Pallas in
  interpret mode) and einsum with ``compute_dtype=jnp.bfloat16``: the
  operands round identically, so only float32 sums differ — 1e-5
  norm-relative (measured ~1e-8).  The fused gradients against JAX's custom
  VJP: 1e-5 (measured ~1e-7).  Against float32, JAX's own bands: 2e-2 of
  the largest value, gradients at rtol 3e-2 (tests/test_pallas.py:83-136).
- ``conv_valid`` on bf16 operands (ROADMAP C1) against ``conv_valid_pallas``
  in interpret mode: values 1e-6, and gradients one bf16 rounding step
  (2^-8 relative) from JAX's VJP at the upcast operands, cast back.  JAX's
  own VJP raises on bf16 operands — its float32 cotangent meets the bf16
  operands in ``lax.conv_general_dilated`` — so the port's gradients are
  held against what that VJP computes once the operands are upcast.
- Three bf16 train steps of a small net against JAX's, both domains and
  ``leaky_relu``: parameters, raw gradients and losses 1e-3 norm-relative
  (measured at most 1.5e-4: FFT and conv results that differ by ~1e-7 round
  to different bf16 values now and then).  The JAX workflows with bf16:
  the coord step with an activation, the float32 target, bf16 with remat,
  accumulation and a torch optimizer, the CLI in both domains.

Tests marked ``cuda`` launch K1 and K2 and need an NVIDIA GPU; they skip
without one, and import no JAX::

    python -m pytest tests/test_torch_bf16.py -m cuda --noconftest
"""

import json

import numpy as np
import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.cli.main import main as tcli
from spectralae_torch.core import types as ttypes
from spectralae_torch.ops import coord as tcoord
from spectralae_torch.ops import coord_kernels as ck
from spectralae_torch.ops import dft as tdft
from spectralae_torch.ops import spectral as tspec
from spectralae_torch.ops import spectral_kernels as sk
from spectralae_torch.train import modern as tmodern

torch.set_num_threads(1)

BF = torch.bfloat16
TOL = 1e-5              # the same rounded operands, float32 sums
STEP_TOL = 1e-3         # three bf16 steps, two frameworks
BF16_STEP = 2.0 ** -8   # one bf16 rounding step, relative


def rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def cplx(rng, *shape):
    return (rng.normal(size=shape)
            + 1j * rng.normal(size=shape)).astype(np.complex64)


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _spectra(seed, nb=2, d=3, m=4, nx=16, ny=16):
    rng = np.random.default_rng(seed)
    X = np.fft.rfft2(rng.normal(size=(nb, d, nx, ny))).astype(np.complex64)
    C = np.fft.rfft2(rng.normal(size=(m, d, nx, ny))).astype(np.complex64)
    b = rng.normal(size=m).astype(np.float32)
    return X, C, b


# ------------------------------------------------- the spectral conv (K1)

@pytest.mark.parametrize("impl", ["fused", "einsum"])
@pytest.mark.parametrize("shape", [(2, 3, 4, 16, 16), (1, 10, 3, 12, 10)])
def test_spectral_conv_bf16_matches_jax(impl, shape):
    _, jnp = _jax()
    from spectralae.ops import pallas_kernels as jpk
    from spectralae.ops import spectral as jspec
    nb, d, m, nx, ny = shape
    X, C, b = _spectra(1, nb, d, m, nx, ny)
    if impl == "fused":
        got = sk.spectral_conv_fused(torch.from_numpy(X), torch.from_numpy(C),
                                     torch.from_numpy(b), nx, ny, True, BF)
        want = jpk.spectral_conv_fused(jnp.asarray(X), jnp.asarray(C),
                                       jnp.asarray(b), nx, ny, True,
                                       jnp.bfloat16)
    else:
        got = tspec.spectral_conv_einsum(
            torch.from_numpy(X), torch.from_numpy(C), torch.from_numpy(b),
            nx, ny, compute_dtype=BF)
        want = jspec.spectral_conv_einsum(
            jnp.asarray(X), jnp.asarray(C), jnp.asarray(b), nx, ny,
            compute_dtype=jnp.bfloat16)
    assert got.dtype == torch.complex64
    assert rel(got, want) < TOL


def test_spectral_conv_bf16_close_to_f32():
    """Values and kernel gradients within bf16 rounding of float32, on both
    implementations (tests/test_pallas.py:83-136)."""
    rng = np.random.default_rng(9)
    nx = ny = 16
    X, C, b = (torch.from_numpy(a) for a in _spectra(9, 2, 3, 4))
    want = tspec.spectral_conv_einsum(X, C, b, nx, ny).numpy()
    got_e = tspec.spectral_conv_einsum(X, C, b, nx, ny,
                                       compute_dtype=BF).numpy()
    got_f = sk.spectral_conv_fused(X, C, b, nx, ny, True, BF)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got_e - want)) < 2e-2 * scale
    assert np.max(np.abs(got_f.numpy() - want)) < 2e-2 * scale
    assert got_f.dtype == torch.complex64

    ck0 = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    for conv in (sk.spectral_conv_fused, tspec.spectral_conv_einsum):
        grads = []
        for cd in (None, BF):
            c = torch.tensor(ck0, requires_grad=True)
            kw = ({"compute_dtype": cd} if conv is tspec.spectral_conv_einsum
                  else {})
            args = (X, tdft.kernel_spectrum(c, nx, ny), b, nx, ny)
            y = (conv(*args, **kw) if kw else conv(*args, True, cd))
            torch.mean(torch.abs(y) ** 2).backward()
            grads.append(c.grad.numpy())
        np.testing.assert_allclose(grads[1], grads[0], rtol=3e-2,
                                   atol=1e-3 * np.max(np.abs(grads[0])))


def test_spectral_conv_fused_bf16_grads_match_jax_vjp():
    """Gradients through rfft2 → kernel spectra → the Function → irfft2
    against JAX's ``_conv_bwd`` with bf16 operands."""
    jax, jnp = _jax()
    from spectralae.ops import dft as jdft
    from spectralae.ops import pallas_kernels as jpk
    rng = np.random.default_rng(2)
    nx = ny = 16
    xs = rng.normal(size=(2, 3, nx, ny)).astype(np.float32)
    c = rng.normal(size=(5, 3, 3, 3)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    target = rng.normal(size=(2, 5, nx, ny)).astype(np.float32)

    def jloss(x, cc, bb):
        y = jpk.spectral_conv_fused(jnp.fft.rfft2(x),
                                    jdft.kernel_spectrum(cc, nx, ny), bb,
                                    nx, ny, True, jnp.bfloat16)
        return jnp.mean((jnp.fft.irfft2(y, s=(nx, ny)) - target) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (xs, c, b)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (xs, c, b)]
    y = sk.spectral_conv_fused(torch.fft.rfft2(leaves[0]),
                               tdft.kernel_spectrum(leaves[1], nx, ny),
                               leaves[2], nx, ny, True, BF)
    loss = torch.mean((torch.fft.irfft2(y, s=(nx, ny))
                       - torch.from_numpy(target)) ** 2)
    loss.backward()
    for t, w in zip(leaves, want):
        assert rel(t.grad, np.asarray(w)) < TOL


def test_fused_bf16_rounds_the_scaled_input():
    """The forward rounds ``X·(1/M)`` (JAX rounds after the scale), not
    ``X``: with M = 10 the two differ."""
    X, C, b = (torch.from_numpy(a) for a in _spectra(3, 2, 3, 10))
    nb, d, nx, nyr = X.shape
    w = nx * nyr
    got = sk.spectral_conv_fused(X, C, b, 16, 16, True, BF)
    planes = {"scaled": sk.bf16_planes(X.reshape(nb, d, w) * (1.0 / 10)),
              "rounded": sk.bf16_planes(X.reshape(nb, d, w))}
    q = sk.bf16_planes(C.reshape(10, d, w)).transpose(0, 1)
    kw = dict(bias=b, bias_scale=256.0)
    want = sk.cmul_contract_plain(planes["scaled"], q, **kw)
    other = sk.cmul_contract_plain(planes["rounded"], q, p_scale=0.1, **kw)
    assert rel(got.reshape(nb, 10, w), want) < 1e-6
    assert rel(other, want) > 1e-4


def test_cmul_contract_bf16_plain_version():
    """bf16 planes: the plain version contracts the exactly upcast operands;
    transposed plane views read as their contiguous copies; the scale and
    the conjugation apply in float32."""
    rng = np.random.default_rng(4)
    p = torch.from_numpy(cplx(rng, 3, 4, 9))
    q = torch.from_numpy(cplx(rng, 5, 4, 9))           # read as [4, 5, 9]
    pp, qp = sk.bf16_planes(p), sk.bf16_planes(q).transpose(0, 1)
    got = sk.cmul_contract(pp, qp, p_scale=0.5, conj_q=True)
    up = {name: torch.complex(t[..., 0].float(), t[..., 1].float())
          for name, t in (("p", pp), ("q", qp.contiguous()))}
    want = torch.einsum("akw,kbw->abw", up["p"].to(torch.complex128) * 0.5,
                        up["q"].conj().to(torch.complex128))
    assert got.dtype == torch.complex64
    assert rel(got, want) < 1e-6
    assert rel(got, torch.einsum("akw,kbw->abw", p * 0.5,
                                 q.transpose(0, 1).conj())) < 2e-2
    with pytest.raises(TypeError):
        sk.cmul_contract(pp, q.transpose(0, 1))        # mixed operand types
    with pytest.raises(ValueError):
        sk.cmul_contract(pp[..., :1], qp[..., :1])     # not (re, im) pairs


# ---------------------------------------------- conv_valid on bf16 (C1)

def _conv_problem(seed, b=2, d=3, m=4, h=12, w=10, nk=5, nl=5):
    rng = np.random.default_rng(seed)
    xpad = rng.normal(size=(b, d, h + nk - 1, w + nl - 1)).astype(np.float32)
    wt = rng.normal(size=(m, d, nk, nl)).astype(np.float32)
    dy = rng.normal(size=(b, m, h, w)).astype(np.float32)
    return xpad, wt, dy


@pytest.mark.parametrize("shape", [(2, 3, 4, 12, 10, 5, 5),
                                   (1, 10, 3, 9, 14, 3, 3)])
def test_conv_valid_bf16_matches_pallas(shape):
    jax, jnp = _jax()
    from spectralae.ops import pallas_conv as jpc
    xpad, wt, dy = _conv_problem(5, *shape)
    xb, wb = (torch.from_numpy(a).to(BF) for a in (xpad, wt))
    jx, jw = (jnp.asarray(a).astype(jnp.bfloat16) for a in (xpad, wt))
    # values: both upcast and return float32
    got = ck.conv_valid(xb, wb)
    want = jpc.conv_valid_pallas(jx, jw)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert rel(got, want) < 1e-6
    # gradients: JAX's VJP at the upcast operands, cast back
    _, vjp = jax.vjp(jpc.conv_valid_pallas, jx.astype(jnp.float32),
                     jw.astype(jnp.float32))
    want_dx, want_dw = (np.asarray(g.astype(jnp.bfloat16).astype(
        jnp.float32)) for g in vjp(jnp.asarray(dy)))
    xt, wt_ = xb.clone().requires_grad_(), wb.clone().requires_grad_()
    ck.conv_valid(xt, wt_).backward(torch.from_numpy(dy))
    assert xt.grad.dtype == BF and wt_.grad.dtype == BF
    for g, w in ((xt.grad, want_dx), (wt_.grad, want_dw)):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=BF16_STEP,
                                   atol=BF16_STEP * 1e-3 * np.abs(w).max())


def test_conv_valid_gradients_take_each_operand_dtype():
    """A bf16 input with float32 weights: dx comes back bf16, dw float32,
    both the float32 gradients of the upcast problem, rounded."""
    xpad, wt, dy = _conv_problem(6)
    xb = torch.from_numpy(xpad).to(BF).requires_grad_()
    w32 = torch.from_numpy(wt).requires_grad_()
    ck.conv_valid(xb, w32).backward(torch.from_numpy(dy))
    x_up = xb.detach().float().requires_grad_()
    w_up = w32.detach().clone().requires_grad_()
    ck.conv_valid_plain(x_up, w_up).backward(torch.from_numpy(dy))
    assert xb.grad.dtype == BF and w32.grad.dtype == torch.float32
    assert torch.equal(xb.grad, x_up.grad.to(BF))
    assert rel(w32.grad, w_up.grad) < 1e-6


@pytest.mark.parametrize("tap", ["centered", "ref_gpu"])
def test_conv2d_kernel_route_bf16_matches_jax(tap):
    """``pallas=True`` with bf16 activations and weights: the kernel's
    float32 result is cast back to the activations' dtype on both sides
    (spectralae/ops/coord.py:78), then the bf16 bias is added."""
    _, jnp = _jax()
    from spectralae.ops import coord as jcoord
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 255, size=(1, 2, 9, 11)).astype(np.float32)
    c = rng.uniform(-3, 3, size=(3, 2, 5, 5)).astype(np.float32)
    b = rng.uniform(-3, 3, size=3).astype(np.float32)
    got = tcoord.conv2d(*(torch.from_numpy(a).to(BF) for a in (x, c, b)),
                        tap_mode=tap, pallas=True)
    want = jcoord.conv2d(*(jnp.asarray(a).astype(jnp.bfloat16)
                           for a in (x, c, b)), tap_mode=tap, pallas=True)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_STEP, atol=1e-2)


# ----------------------------------------------------- bf16 train steps

def _net(seed=0, pairs=2, batch=2, steps=3, nx=32):
    from spectralae.core import types as jtypes
    from spectralae.core.config import Config, LayerParams
    _, jnp = _jax()
    cfg = Config(nx=nx, ny=nx, d=3, layer=LayerParams(depth=4))
    spec = jtypes.initial_spec(cfg)
    for _ in range(pairs - 1):
        spec = spec.add_pair(cfg.layer)
    rng = np.random.default_rng(seed)
    arrays = [(rng.uniform(-1, 1, (s.m, s.d, s.nk, s.nl)).astype(np.float32),
               rng.uniform(-1, 1, s.m).astype(np.float32))
              for s in spec.stages]
    xs = [rng.uniform(0, 255, (batch, 3, nx, nx)).astype(np.float32)
          for _ in range(steps)]
    jp = jtypes.AEParams(stages=tuple(
        jtypes.ConvStage(c=jnp.asarray(c), b=jnp.asarray(b))
        for c, b in arrays))
    return jp, ttypes.params_from_numpy(arrays), spec, xs


def _flat(params) -> np.ndarray:
    return np.concatenate([np.asarray(t, np.float32).ravel()
                           for st in params.stages for t in (st.c, st.b)])


@pytest.mark.parametrize("domain,act", [("fft", None), ("coord", None),
                                        ("coord", "leaky_relu")])
def test_bf16_train_step_matches_jax(domain, act):
    """Three bf16 steps of each package from the same weights and frames:
    parameters, raw gradients and losses within STEP_TOL at every step;
    the parameters stay float32."""
    _, jnp = _jax()
    from spectralae.core import types as jtypes
    from spectralae.ops.coord import leaky_relu as jlr
    from spectralae.train import modern as jmodern
    jp, tp, spec, xs = _net()
    jo, to = jtypes.init_opt_state(jp), ttypes.init_opt_state(tp)
    for x in xs:
        jr = jmodern.train_step(jp, jo, jnp.asarray(x), spec.scales,
                                domain=domain, compute_dtype=jnp.bfloat16,
                                act=jlr if act else None)
        tr = tmodern.train_step(tp, to, torch.from_numpy(x), spec.scales,
                                domain=domain, compute_dtype=BF,
                                act=tcoord.leaky_relu if act else None)
        assert rel(_flat(tr.params), _flat(jr.params)) < STEP_TOL
        assert rel(_flat(tr.opt.prev_grad),
                   _flat(jr.opt.prev_grad)) < STEP_TOL
        assert abs(float(tr.loss) / float(jr.loss) - 1) < STEP_TOL
        jp, jo, tp, to = jr.params, jr.opt, tr.params, tr.opt
    assert all(t.dtype == torch.float32 for t in tp.leaves())


def test_bf16_compute_and_activation():
    """The coord bf16 step with leaky_relu trains, and the params stay
    float32 (tests/test_modern_dist.py:106-123)."""
    _, tp, spec, xs = _net(pairs=1, batch=4, nx=16)
    opt = ttypes.init_opt_state(tp)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 3, 16, 16)).astype(np.float32)) * 20
    losses = []
    for _ in range(60):
        res = tmodern.train_step(tp, opt, x, spec.scales, lr=0.5,
                                 domain="coord", compute_dtype=BF,
                                 act=tcoord.leaky_relu)
        tp, opt = res.params, res.opt
        losses.append(float(res.loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.98
    assert tp.stages[0].c.dtype == torch.float32


def test_coord_bf16_loss_targets_full_precision_input():
    """The coord bf16 loss compares against the float32 input, not its bf16
    rounding (tests/test_modern_dist.py:262-281)."""
    _, tp, spec, _ = _net(pairs=1, nx=16)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 3, 16, 16)).astype(np.float32)) * 20
    l32 = float(tmodern.reconstruction_loss(tp, x, spec.scales,
                                            domain="coord"))
    l16 = float(tmodern.reconstruction_loss(tp, x, spec.scales,
                                            domain="coord",
                                            compute_dtype=BF))
    assert abs(l16 - l32) / l32 < 0.02
    zero = ttypes.AEParams.from_leaves([torch.zeros_like(t)
                                        for t in tp.leaves()])
    lz = float(tmodern.reconstruction_loss(zero, x, spec.scales,
                                           domain="coord", compute_dtype=BF))
    np.testing.assert_allclose(lz, float(0.5 * torch.mean(x ** 2)),
                               rtol=1e-6)


def test_modern_fft_train_step_bf16_decreases_loss():
    """tests/test_pallas.py:138-160: forty fft bf16 steps cut the loss."""
    _, tp, spec, _ = _net(pairs=1, nx=16)
    opt = ttypes.init_opt_state(tp)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 3, 16, 16)).astype(np.float32)) * 20
    losses = []
    for _ in range(40):
        res = tmodern.train_step(tp, opt, x, spec.scales, lr=0.5,
                                 domain="fft", compute_dtype=BF)
        tp, opt = res.params, res.opt
        losses.append(float(res.loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9


def test_production_features_compose():
    """bf16 operands, remat, accumulation and a torch optimizer in one run
    (tests/test_workflows.py:111-140)."""
    _, tp, spec, _ = _net(pairs=1, nx=16)
    optimizer = tmodern.make_optimizer("adam", 0.3)
    step = tmodern.make_optim_train_step(optimizer, domain="fft",
                                         compute_dtype=BF, remat=True,
                                         accum_steps=2)
    opt = optimizer.init(tp)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 3, 16, 16)).astype(np.float32)) * 20
    losses = []
    for _ in range(30):
        res = step(tp, opt, x, spec.scales)
        tp, opt = res.params, res.opt
        losses.append(float(res.loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9
    assert tp.stages[0].c.dtype == torch.float32


@pytest.mark.parametrize("domain,act", [("coord", "leaky_relu"),
                                        ("fft", "identity")])
def test_cli_train_bf16(capsys, domain, act):
    """``train --bf16`` on the CPU (tests/test_engine_cli.py:1010 and its
    fft twin): three finite losses, one per step."""
    tcli(["train", "--device", "cpu", "--nx", "16", "--steps", "3",
          "--batch", "2", "--domain", domain, "--bf16", "--activation", act,
          "--log-every", "1"])
    losses = [json.loads(line)["loss"] for line in
              capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(losses) == 3 and np.isfinite(losses).all()


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_planes(gen, dev, *shape):
    z = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    return sk.bf16_planes(z)


@pytest.mark.cuda
@pytest.mark.parametrize("a,k,b,n", [(8, 3, 10, 128), (8, 10, 3, 64),
                                     (3, 2, 17, 9)])
def test_cmul_contract_bf16_forward_on_card(cuda_device, a, k, b, n):
    """The forward's form — q the transposed kernel spectra, the DC bias —
    at the net's widths and at an odd W (a partial last block)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = n * (n // 2 + 1)
    p = _card_planes(gen, cuda_device, a, k, w)
    q = _card_planes(gen, cuda_device, b, k, w).transpose(0, 1)
    bias = torch.randn(b, device=cuda_device, generator=gen)
    kw = dict(bias=bias, bias_scale=float(n * n))
    before = sk.k1_launches(True)
    got = sk.cmul_contract(p, q, **kw)
    torch.cuda.synchronize()
    assert sk.k1_launches(True) == before + 1
    assert rel(got.cpu(), sk.cmul_contract_plain(p, q, **kw).cpu()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("a,k,b,n", [(8, 10, 3, 128), (10, 8, 10, 32),
                                     (3, 2, 17, 7)])
def test_cmul_contract_bf16_backward_forms_on_card(cuda_device, a, k, b, n):
    """dX (``q`` conjugated, ``p_scale`` in the kernel) and dC (``p`` the
    transposed cotangent's planes, a strided view)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    w = n * (n // 2 + 1)
    g = _card_planes(gen, cuda_device, k, a, w)
    q = _card_planes(gen, cuda_device, k, b, w)
    for p, scale in ((g.transpose(0, 1), 1.0),
                     (g.transpose(0, 1).contiguous(), 0.1)):
        before = sk.k1_launches(True)
        got = sk.cmul_contract(p, q, p_scale=scale, conj_q=True)
        torch.cuda.synchronize()
        assert sk.k1_launches(True) == before + 1
        want = sk.cmul_contract_plain(p.contiguous(), q, p_scale=scale,
                                      conj_q=True)
        assert rel(got.cpu(), want.cpu()) < 1e-6


@pytest.mark.cuda
def test_spectral_conv_fused_bf16_grads_on_card(cuda_device):
    """The bf16 Function on the card (three K1 launches: forward, dX, dC)
    against the same Function on the CPU, where the plain version runs."""
    gen = torch.Generator().manual_seed(3)
    n, nb, d, m = 64, 4, 3, 10
    x = torch.randn(nb, d, n, n, generator=gen)
    c0 = torch.randn(m, d, 5, 5, generator=gen)
    b0 = torch.randn(m, generator=gen)
    dy = torch.randn(nb, m, n, n, generator=gen)
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.to(dev).requires_grad_() for t in (x, c0, b0)]
        y = torch.fft.irfft2(sk.spectral_conv_fused(
            torch.fft.rfft2(leaves[0]), tdft.kernel_spectrum(leaves[1], n, n),
            leaves[2], n, n, True, BF), s=(n, n))
        before = sk.k1_launches(True)
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(
            y, leaves, dy.to(dev))]
        if dev != "cpu":
            assert sk.k1_launches(True) == before + 2
    # the card's float32 FFTs move a few operands across a bf16 rounding
    # boundary: 1e-4 (the step tolerance of chip_smoke.py's fft domain)
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert rel(got, want) < 1e-4


@pytest.mark.cuda
def test_conv_valid_bf16_on_card(cuda_device):
    """C1 on the card: bf16 operands are upcast, K2 runs in float32, and
    the gradients come back in the operands' dtypes."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    xpad = torch.randn(4, 3, 68, 68, device=cuda_device,
                       generator=gen).to(BF)
    w = torch.randn(10, 3, 5, 5, device=cuda_device, generator=gen).to(BF)
    dy = torch.randn(4, 10, 64, 64, device=cuda_device, generator=gen)
    xt, wt = xpad.clone().requires_grad_(), w.clone().requires_grad_()
    before = _kernels.LAUNCHES["conv_valid"]
    out = ck.conv_valid(xt, wt)
    out.backward(dy)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["conv_valid"] == before + 1
    assert out.dtype == torch.float32
    assert xt.grad.dtype == BF and wt.grad.dtype == BF
    want = ck.conv_valid_plain(xpad.double(), w.double())
    assert rel(out.detach().cpu(), want.cpu()) < 1e-6
