"""spectralae_torch.optim / the torch.optim optimizers against JAX (CPU).

The reference's inertia update is elementwise float32 arithmetic in the
same order in both frameworks: held to 1e-6 relative.  The ``torch.optim``
optimizers against optax, through three whole train steps of a small net:
parameters norm-relative 1e-5 (Adam's moments are updated in another order,
and the net's float32 FFTs come from two libraries); the loss relative 1e-4,
since the untrained net amplifies its parameters' last bits into a loss of
order 1e8.  Schedules are scalar formulas: 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spectralae.core import types as jtypes
from spectralae.core.config import Config, LayerParams
from spectralae.optim import update as jupd
from spectralae.train import modern as jmodern
from spectralae_torch.core import types as ttypes
from spectralae_torch.optim import update as tupd
from spectralae_torch.train import modern as tmodern

torch.set_num_threads(1)

ELEM_TOL = 1e-6
STEP_TOL = 1e-5
LOSS_TOL = 1e-4


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def update_inputs(seed: int, shape=(4, 3, 5, 5)):
    """w, g, mom, prev_grad with the corner cases of the active rule: zero
    momentum (the bootstrap), an unchanged gradient (Δg = 0), gradients
    on both sides of the clip floor."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    g = (rng.normal(size=shape) * 20).astype(np.float32)
    mom = rng.normal(size=shape).astype(np.float32)
    mom.flat[::3] = 0.0
    pg = (rng.normal(size=shape) * 20).astype(np.float32)
    pg.flat[1::4] = g.flat[1::4]
    return w, g, mom, pg


@pytest.mark.parametrize("active", [False, True])
def test_normalized_momentum_update_matches_jax(active):
    w, g, mom, pg = update_inputs(0)
    got = tupd.normalized_momentum_update(
        *(torch.from_numpy(a) for a in (w, g, mom, pg)), 0.2, 0.9,
        active=active)
    want = jupd.normalized_momentum_update(
        *(jnp.asarray(a) for a in (w, g, mom, pg)), 0.2, 0.9, active=active)
    assert tupd.GRAD_CLIP == jupd.GRAD_CLIP
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=ELEM_TOL,
                                   atol=0)


def _tapes(seed: int, n_stages: int = 4):
    """Four numpy tapes of [(c, b), ...]: params, grads, moms, prev grads."""
    out = []
    for k in range(4):
        rng = np.random.default_rng(seed + k)
        scale = 20.0 if k in (1, 3) else 1.0
        out.append([((rng.normal(size=(3, 2, 5, 5)) * scale).astype(
            np.float32), (rng.normal(size=3) * scale).astype(np.float32))
            for _ in range(n_stages)])
    out[2][0] = (np.zeros_like(out[2][0][0]), np.zeros_like(out[2][0][1]))
    return out


def _jax_tape(arrays):
    return jtypes.AEParams(stages=tuple(
        jtypes.ConvStage(c=jnp.asarray(c), b=jnp.asarray(b))
        for c, b in arrays))


@pytest.mark.parametrize("active", [False, True])
def test_tree_update_matches_jax(active):
    tapes = _tapes(1)
    got = tupd.tree_update(*(ttypes.params_from_numpy(t) for t in tapes),
                           0.3, 0.8, active=active)
    want = jupd.tree_update(*(_jax_tape(t) for t in tapes), 0.3, 0.8,
                            active=active)
    for g_tape, w_tape in zip(got, want):
        for gs, ws in zip(g_tape.stages, w_tape.stages):
            np.testing.assert_allclose(gs.c.numpy(), np.asarray(ws.c),
                                       rtol=ELEM_TOL, atol=0)
            np.testing.assert_allclose(gs.b.numpy(), np.asarray(ws.b),
                                       rtol=ELEM_TOL, atol=0)


@pytest.mark.parametrize("lr,alpha", [(0.2, 0.9), (0.3, 0.8), (1.0, 0.0)])
def test_tree_update_equals_the_per_leaf_update_bit_for_bit(lr, alpha):
    """The fixed-rate update, all leaves an operation at once, gives each
    leaf what :func:`normalized_momentum_update` gives it, bit for bit,
    hands the gradients on as ``prev_grad`` and leaves its arguments
    alone."""
    ported = [ttypes.params_from_numpy(t) for t in _tapes(5)]
    before = [[t.clone() for t in p.leaves()] for p in ported]
    new_w, new_mom, new_pg = tupd.tree_update(*ported, lr, alpha)
    for i, (w, g, m, pg) in enumerate(zip(*(p.leaves() for p in ported))):
        want = tupd.normalized_momentum_update(w, g, m, pg, lr, alpha)
        assert torch.equal(new_w.leaves()[i], want.w)
        assert torch.equal(new_mom.leaves()[i], want.mom)
        assert new_pg.leaves()[i] is g
    for p, b in zip(ported, before):
        for t, t0 in zip(p.leaves(), b):
            assert torch.equal(t, t0)


@pytest.mark.parametrize("with_scale", [False, True])
def test_burst_inertia_matches_jax(with_scale):
    w, g, mom, _ = update_inputs(2)
    scale = np.random.default_rng(3).uniform(0, 2, w.shape).astype(
        np.float32) if with_scale else None
    got = tupd.burst_inertia(
        torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(mom),
        0.02, 0.9, None if scale is None else torch.from_numpy(scale))
    want = jupd.burst_inertia(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(mom), 0.02, 0.9,
        None if scale is None else jnp.asarray(scale))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=ELEM_TOL,
                                   atol=0)


def test_updates_leave_their_arguments_alone():
    tapes = _tapes(4)
    ported = [ttypes.params_from_numpy(t) for t in tapes]
    before = [[t.clone() for t in p.leaves()] for p in ported]
    tupd.tree_update(*ported, 0.2, 0.9, active=True)
    for p, b in zip(ported, before):
        for t, t0 in zip(p.leaves(), b):
            assert torch.equal(t, t0)


def test_opt_state_round_trips_through_numpy():
    tapes = _tapes(5)
    opt = ttypes.opt_state_from_numpy(tapes[2], tapes[3])
    mom, pg = ttypes.opt_state_to_numpy(opt)
    for got, want in zip(mom + pg, tapes[2] + tapes[3]):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    params = ttypes.params_from_numpy(tapes[0])
    fresh = ttypes.init_opt_state(params)
    for t, p in zip(fresh.mom.leaves() + fresh.prev_grad.leaves(),
                    params.leaves() * 2):
        assert t.shape == p.shape and not t.any()
    assert [t.shape for t in params.leaves()] == \
        [t.shape for t in ttypes.AEParams.from_leaves(
            params.leaves()).leaves()]


@pytest.mark.parametrize("schedule,warmup", [("constant", 0),
                                             ("constant", 3),
                                             ("cosine", 2), ("linear", 2),
                                             ("cosine", 0)])
def test_schedules_match_optax(schedule, warmup):
    total = 8
    got = tmodern.make_optimizer("sgd", 0.05, schedule=schedule,
                                 warmup_steps=warmup, total_steps=total,
                                 end_lr_frac=0.1).schedule
    want_opt = jmodern.make_optimizer("sgd", 0.05, schedule=schedule,
                                      warmup_steps=warmup, total_steps=total,
                                      end_lr_frac=0.1)
    # the schedule's value is what optax's sgd scales its momentum trace
    # by: with a constant gradient of 1 the trace is t = 1 + 0.9·t
    state = want_opt.init(jnp.zeros(1))
    trace = np.float32(0.0)
    for count in range(total + 2):
        upd, state = want_opt.update(jnp.ones(1), state, jnp.zeros(1))
        trace = np.float32(1.0) + np.float32(0.9) * trace
        lr_optax = -float(upd[0]) / float(trace)
        assert abs(got(count) - lr_optax) <= 1e-6 * max(abs(lr_optax), 1e-3)


def _net(seed: int = 0):
    cfg = Config(nx=16, ny=16, d=3, layer=LayerParams(depth=4))
    spec = jtypes.initial_spec(cfg)
    spec = spec.add_pair(cfg.layer)
    rng = np.random.default_rng(seed)
    arrays = [(rng.uniform(-3, 3, (s.m, s.d, s.nk, s.nl)).astype(np.float32),
               rng.uniform(-3, 3, s.m).astype(np.float32))
              for s in spec.stages]
    xs = [rng.uniform(0, 255, (2, 3, 16, 16)).astype(np.float32)
          for _ in range(3)]
    return arrays, spec, xs


# learning rates that keep three steps of each optimizer from diverging:
# the reconstruction loss's gradients are of order 1e8
@pytest.mark.parametrize("name,lr", [("adam", 0.01), ("adamw", 0.01),
                                     ("sgd", 1e-10)])
def test_optimizers_match_optax_over_three_steps(name, lr):
    arrays, spec, xs = _net()
    kw = dict(schedule="cosine", warmup_steps=1, total_steps=3)
    t_opt = tmodern.make_optimizer(name, lr, **kw)
    j_opt = jmodern.make_optimizer(name, lr, **kw)
    t_step = tmodern.make_optim_train_step(t_opt, domain="fft")
    j_step = jmodern.make_optax_train_step(j_opt, domain="fft")
    tp = ttypes.params_from_numpy(arrays)
    jp = _jax_tape(arrays)
    ts, js = t_opt.init(tp), j_opt.init(jp)
    for x in xs:
        t_res = t_step(tp, ts, torch.from_numpy(x), spec.scales)
        j_res = j_step(jp, js, jnp.asarray(x), spec.scales)
        assert abs(float(t_res.loss) - float(j_res.loss)) <= \
            LOSS_TOL * abs(float(j_res.loss))
        tp, ts, jp, js = t_res.params, t_res.opt, j_res.params, j_res.opt
    got = np.concatenate([t.numpy().ravel() for t in tp.leaves()])
    want = np.concatenate([np.asarray(t).ravel()
                           for st in jp.stages for t in (st.c, st.b)])
    assert rel(got, want) < STEP_TOL
    # the warmup's first update used schedule(0) = 0; the later ones moved
    # the parameters
    assert not np.array_equal(got, np.concatenate([np.ravel(a) for st in
                                                   arrays for a in st]))


def test_optimizer_update_is_functional():
    arrays, spec, xs = _net(1)
    opt = tmodern.make_optimizer("adam", 0.05)
    step = tmodern.make_optim_train_step(opt, domain="coord")
    params = ttypes.params_from_numpy(arrays)
    state = opt.init(params)
    res1 = step(params, state, torch.from_numpy(xs[0]), spec.scales)
    again = step(params, state, torch.from_numpy(xs[0]), spec.scales)
    # the same inputs give the same step: neither call changed them
    for a, b in zip(res1.params.leaves(), again.params.leaves()):
        assert torch.equal(a, b)
    assert state["count"] == 0 and res1.opt["count"] == 1
    with pytest.raises(ValueError, match="unknown optimizer"):
        tmodern.make_optimizer("lamb", 0.1)
    with pytest.raises(ValueError, match="total_steps"):
        tmodern.make_optimizer("sgd", 0.1, schedule="cosine")
