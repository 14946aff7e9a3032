"""Coordinate-domain streaming of the port (``coord_stream``) on the CPU.

- Against the JAX package's ``coord_stream`` from the same weights and
  frames at ``(n_l, q)`` = (0, 1) and (1, 2), single and batched frames,
  with ``sym``: weights, momentum and per-frame mses at norm-relative 1e-5
  (three frames of float32 convolutions summed in another order).
- Against the port's own host loop [forward_coord → center_crop →
  coord_step → replace_pair] (tests/test_streaming.py's equality): the
  weights bit for bit, the mses at 1e-6 (two float32 reductions of one
  sum).
- Training descends on a static scene.

The test marked ``cuda`` runs the stream on the card against the CPU (K2
twice a frame); JAX is imported inside the tests that compare with it, so
that it runs where JAX is not installed::

    python -m pytest tests/test_torch_coord_stream.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.core.config import Config, LayerParams
from spectralae_torch.core.types import (AEParams, ConvStage, init_params,
                                         initial_spec, params_from_numpy)
from spectralae_torch.model import autoencoder as tmodel
from spectralae_torch.ops import coord as tcoord_ops
from spectralae_torch.train.coord import coord_step
from spectralae_torch.train.streaming import coord_stream
from torch_dist_worker import world  # noqa: F401 (a fixture)

torch.set_num_threads(1)

TOL = 1e-5


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _net(nx=16, depth=4, seed=0, rmax=0.4):
    cfg = Config(nx=nx, ny=nx, d=3,
                 layer=LayerParams(depth=depth, lk=0, ll=0, scale=2,
                                   rmax=rmax))
    spec = initial_spec(cfg).add_pair(cfg.layer)
    return init_params(torch.Generator().manual_seed(seed), spec,
                       cfg.layer.rmax), spec


def _frames(seed, shape=(3, 3, 16, 16)):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32)


def _jax_stream(params, spec, xs, n_l, **kw):
    import jax.numpy as jnp
    from spectralae.core.types import AEParams as JParams
    from spectralae.core.types import ConvStage as JStage
    from spectralae.train.streaming import coord_stream as jstream
    jp = JParams(stages=tuple(JStage(c=jnp.asarray(s.c.numpy()),
                                     b=jnp.asarray(s.b.numpy()))
                              for s in params.stages))
    return jstream(jnp.asarray(xs), jp, spec.scales, n_l, **kw)


@pytest.mark.parametrize("n_l,q", [(0, 1), (1, 2)])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "b2"])
@pytest.mark.parametrize("sym", [False, True])
def test_coord_stream_matches_jax(n_l, q, batched, sym):
    params, spec = _net()
    xs = _frames(11, (3, 2, 3, 16, 16) if batched else (3, 3, 16, 16))
    got = coord_stream(torch.from_numpy(xs), params, spec.scales, n_l, q=q,
                       lr=0.3, sym=sym)
    want = _jax_stream(params, spec, xs, n_l, q=q, lr=0.3, sym=sym)
    for g, w in zip(got.params.stages, want.params.stages):
        assert rel(g.c, w.c) < TOL and rel(g.b, w.b) < TOL
    for g, w in zip(got.mom + got.prev_grad, want.mom + want.prev_grad):
        if np.linalg.norm(np.asarray(w)) > 0:   # sym leaves Df zero
            assert rel(g, w) < TOL
    assert got.mses.shape == (3,)
    assert rel(got.mses, want.mses) < TOL


@pytest.mark.parametrize("n_l,q", [(0, 1), (1, 2)])
def test_coord_stream_equals_sequential_steps(n_l, q):
    """coord_stream == the host loop [forward_coord → center_crop →
    coord_step → replace_pair] (the engine's coord-domain '1' loop)."""
    params, spec = _net()
    xs = torch.from_numpy(_frames(11))
    got = coord_stream(xs, params, spec.scales, n_l, q=q, lr=0.3)
    prm = params
    enc, dec = prm.pair(n_l)
    mom = tuple(torch.zeros_like(t) for t in (enc.c, dec.c, enc.b, dec.b))
    pg = tuple(torch.zeros_like(t) for t in mom)
    n_acts = 2 * prm.n_stages + 1
    mses = []
    for k in range(xs.shape[0]):
        acts = tmodel.forward_coord(prm, xs[k][None], spec.scales,
                                    tap_mode="ref_gpu")
        in_s = tcoord_ops.center_crop(acts[2 * n_l + 1][0], q)
        hin_s = tcoord_ops.center_crop(acts[2 * n_l + 2][0], q)
        out_s = tcoord_ops.center_crop(acts[n_acts - 2 - 2 * n_l][0], q)
        e2, d2 = prm.pair(n_l)
        r = coord_step(in_s, out_s, hin_s, e2.c, d2.c, e2.b, d2.b, mom, pg,
                       lr=0.3)
        mom, pg = r.mom, r.prev_grad
        prm = prm.replace_pair(n_l, ConvStage(c=r.c, b=r.b),
                               ConvStage(c=r.f, b=r.p))
        mses.append(float(r.mse))
    for a, b in zip(got.params.stages, prm.stages):
        assert torch.equal(a.c, b.c) and torch.equal(a.b, b.b)
    np.testing.assert_allclose(got.mses.numpy(), mses, rtol=1e-6)


def test_coord_stream_carries_state_across_blocks():
    """Two blocks with the state handed on == one block of all frames (the
    CLI's flush blocks: --stream-k is a performance knob only)."""
    params, spec = _net()
    xs = torch.from_numpy(_frames(12, (4, 3, 16, 16)))
    whole = coord_stream(xs, params, spec.scales, 0, lr=0.2, active=True)
    a = coord_stream(xs[:2], params, spec.scales, 0, lr=0.2, active=True)
    b = coord_stream(xs[2:], a.params, spec.scales, 0, lr=0.2, active=True,
                     mom=a.mom, prev_grad=a.prev_grad)
    for x, y in zip(whole.params.stages, b.params.stages):
        assert torch.equal(x.c, y.c)
    assert torch.equal(whole.mses, torch.cat([a.mses, b.mses]))


def test_coord_stream_descends_on_a_static_scene():
    """One reference coord step per frame on a repeated pixel-scale frame:
    the per-frame mse falls (the JAX CLI test's scene: the default
    one-pair net, 24 frames, lr 0.2)."""
    cfg = Config(nx=32, ny=32)
    spec = initial_spec(cfg)
    params = init_params(torch.Generator().manual_seed(0), spec,
                         cfg.layer.rmax)
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 255, size=(3, 32, 32)).astype(np.float32)
    xs = torch.from_numpy(np.repeat(frame[None], 24, axis=0))
    r = coord_stream(xs, params, spec.scales, 0, lr=0.2)
    mses = r.mses.numpy()
    assert np.isfinite(mses).all()
    assert mses[-1] < 0.5 * mses[0]


def test_coord_stream_with_axis_name_matches_jax(world):
    """The data-parallel stream (``axis_name``, here an axis of one rank)
    against JAX's stream; the gloo meshes of two and four ranks are in
    tests/test_torch_dist.py."""
    params, spec = _net()
    xs = _frames(1, (3, 2, 3, 16, 16))
    got = coord_stream(torch.from_numpy(xs), params, spec.scales, 0,
                       lr=0.3, axis_name=world)
    want = _jax_stream(params, spec, xs, 0, lr=0.3)
    for g, w in zip(got.params.stages, want.params.stages):
        assert rel(g.c, w.c) < TOL and rel(g.b, w.b) < TOL
    assert rel(got.mses, want.mses) < TOL


@pytest.mark.cuda
def test_coord_stream_on_card_matches_cpu(monkeypatch):
    """The default net's widths (D=3, M=10, 5x5) at 64^2, batch 4: the
    stream on the card (K2 for the 3->10 and 10->3 convs, twice a frame)
    against the CPU's plain versions — weights, momentum and mses at the
    tolerances chip_smoke.py holds the coord trainer to (1e-5; momentum
    1e-4: the last update step carries the small gradients' absolute
    error).  cuDNN's TF32 stays at PyTorch's default (on): the stream's
    library convs run in IEEE float32 by themselves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg = Config(nx=64, ny=64)
    spec = initial_spec(cfg).add_pair(cfg.layer).add_pair(cfg.layer)
    params = init_params(torch.Generator().manual_seed(0), spec,
                         cfg.layer.rmax)
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.uniform(0, 255, size=(3, 4, 3, 64, 64))
                          .astype(np.float32))
    cpu = coord_stream(xs, params, spec.scales, 0)
    on = AEParams.from_leaves([t.cuda() for t in params.leaves()])
    before = _kernels.LAUNCHES["conv_valid"]
    card = coord_stream(xs.cuda(), on, spec.scales, 0)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["conv_valid"] - before == 2 * 3
    flat = lambda ts: np.concatenate([t.cpu().numpy().ravel() for t in ts])
    assert rel(flat(card.params.leaves()), flat(cpu.params.leaves())) < 1e-5
    assert rel(flat(card.mom), flat(cpu.mom)) < 1e-4
    assert rel(card.mses.cpu(), cpu.mses) < 1e-5


def test_params_from_numpy_carries_jax_weights():
    """The Engine and stream tests carry the JAX package's weights across
    as numpy: params_from_numpy gives the same tape back."""
    params, _ = _net()
    back = params_from_numpy([(s.c.numpy(), s.b.numpy())
                              for s in params.stages])
    for a, b in zip(params.stages, back.stages):
        assert torch.equal(a.c, b.c) and torch.equal(a.b, b.b)
