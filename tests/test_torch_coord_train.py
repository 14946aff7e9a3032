"""spectralae_torch.train.coord against the JAX package and the numpy oracle
(CPU).

- ``coord_ref_gradients``: both impls ('transpose': autograd of the linear
  conv; 'patches': ``F.unfold`` patches) in the three tap modes, against
  JAX's ``coord_ref_gradients`` and each other at norm-relative 1e-5
  (float32 convolutions summed in another order; measured ≤ 4e-7), and
  against ``tests/oracle.py::gradient_coord_ref`` (float64 loops; the
  'centered' and 'ref_gpu' windows, which it models) at 1e-5.
- ``coord_step``: three chained steps with ``sym`` and ``active`` on and
  off, weights, momentum, previous gradient and mse against JAX at 1e-5.
- ``coord_step_dp``: at B=1 equal to ``coord_step`` (the same gradients;
  the two mse reductions may differ in the last bit: 1e-6), at B=3
  against JAX's vmapped mean at 1e-5; ``axis_name`` is refused.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from spectralae.train import coord as jcoord
from spectralae_torch.train import coord as tcoord
from torch_dist_worker import world  # noqa: F401 (a fixture)

torch.set_num_threads(1)

TOL = 1e-5
TAPS = ("centered", "ref_gpu", "ref_cpu")


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def grads_problem(seed, d=2, m=3, nk=3, n=12, b=None):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    in_s = rng.normal(size=lead + (d, n, n)).astype(np.float32)
    out_s = rng.normal(size=lead + (d, n, n)).astype(np.float32)
    hin_s = rng.normal(size=lead + (m, n, n)).astype(np.float32)
    f = rng.normal(size=(d, m, nk, nk)).astype(np.float32)
    return in_s, out_s, hin_s, f


def step_problem(seed, d=3, m=4, nk=3, n=10, b=None):
    """Pixel-scale activations and reference-scale weights (the clip at
    GRAD_CLIP and the secant rule both see realistic gradients)."""
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    in_s = rng.uniform(0, 255, size=lead + (d, n, n)).astype(np.float32)
    out_s = (in_s + rng.normal(0, 30, size=in_s.shape)).astype(np.float32)
    hin_s = rng.normal(0, 50, size=lead + (m, n, n)).astype(np.float32)
    c = rng.uniform(-3, 3, size=(m, d, nk, nk)).astype(np.float32)
    f = rng.uniform(-3, 3, size=(d, m, nk, nk)).astype(np.float32)
    bb = rng.uniform(-3, 3, size=m).astype(np.float32)
    p = rng.uniform(-3, 3, size=d).astype(np.float32)
    return (in_s, out_s, hin_s), (c, f, bb, p)


@pytest.mark.parametrize("impl", ["transpose", "patches"])
@pytest.mark.parametrize("tap", TAPS)
@pytest.mark.parametrize("nk", [3, 5])
def test_coord_ref_gradients_match_jax(impl, tap, nk):
    a = grads_problem(nk, nk=nk)
    want = jcoord.coord_ref_gradients(*(jnp.asarray(t) for t in a), nk, nk,
                                      tap_mode=tap, impl=impl)
    got = tcoord.coord_ref_gradients(*(torch.from_numpy(t) for t in a), nk,
                                     nk, tap_mode=tap, impl=impl)
    for name, g, w in zip(got._fields, got, want):
        assert g.shape == w.shape, name
        assert rel(g, w) < TOL, (name, rel(g, w))


@pytest.mark.parametrize("tap", TAPS)
def test_coord_gradient_impls_agree(tap):
    """'patches' == 'transpose' in every tap window (the twin of
    tests/test_gradients.py::test_coord_gradient_impls_agree)."""
    a = [torch.from_numpy(t) for t in grads_problem(7)]
    x = tcoord.coord_ref_gradients(*a, 3, 3, tap_mode=tap, impl="transpose")
    y = tcoord.coord_ref_gradients(*a, 3, 3, tap_mode=tap, impl="patches")
    for name, g, w in zip(x._fields, x, y):
        assert rel(g, w) < TOL, (name, rel(g, w))


# the oracle models the three tap windows' anchors but not the CPU conv's
# strict bound (row and column 0 of each conv input masked), so 'ref_cpu'
# is held against JAX and the other impl only
@pytest.mark.parametrize("impl", ["transpose", "patches"])
@pytest.mark.parametrize("tap", ["centered", "ref_gpu"])
def test_coord_ref_gradients_match_oracle(impl, tap):
    in_s, out_s, hin_s, f = grads_problem(2, n=8)
    want = oracle.gradient_coord_ref(in_s, out_s, hin_s, f, mode=tap)
    got = tcoord.coord_ref_gradients(
        *(torch.from_numpy(t) for t in (in_s, out_s, hin_s, f)), 3, 3,
        tap_mode=tap, impl=impl)
    for name, g, w in zip(got._fields, got, want):
        assert rel(g, w) < TOL, (name, rel(g, w))


def test_transposes_keep_autograd_under_inference_mode():
    """The Engine's loop runs under no_grad; the transposes switch autograd
    on themselves, so inference_mode and no_grad change nothing."""
    a = [torch.from_numpy(t) for t in grads_problem(4)]
    want = tcoord.coord_ref_gradients(*a, 3, 3)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            got = tcoord.coord_ref_gradients(*a, 3, 3)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_unknown_impl_is_refused():
    a = [torch.from_numpy(t) for t in grads_problem(4)]
    with pytest.raises(ValueError, match="impl"):
        tcoord.coord_ref_gradients(*a, 3, 3, impl="loops")


def _zeros(ws):
    return tuple(np.zeros_like(w) for w in ws)


def _run_steps(lib, acts, ws, n_steps, **kw):
    """``n_steps`` chained ``coord_step`` calls of one package (the
    activations shifted each step, the state carried)."""
    conv = jnp.asarray if lib is jcoord else torch.from_numpy
    c, f, b, p = (conv(w) for w in ws)
    mom = tuple(conv(z) for z in _zeros(ws))
    pg = tuple(conv(z) for z in _zeros(ws))
    for k in range(n_steps):
        a = [conv(np.roll(t, k, axis=-1).copy()) for t in acts]
        r = lib.coord_step(*a, c, f, b, p, mom, pg, lr=0.2, alpha=0.9, **kw)
        c, f, b, p, mom, pg = r.c, r.f, r.b, r.p, r.mom, r.prev_grad
    return r


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("active", [False, True])
def test_coord_step_matches_jax(sym, active):
    acts, ws = step_problem(3)
    got = _run_steps(tcoord, acts, ws, 3, sym=sym, active=active,
                     tap_mode="ref_gpu")
    want = _run_steps(jcoord, acts, ws, 3, sym=sym, active=active,
                      tap_mode="ref_gpu")
    for name in ("c", "f", "b", "p"):
        assert rel(getattr(got, name), getattr(want, name)) < TOL, name
    for name in ("mom", "prev_grad"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            if np.linalg.norm(np.asarray(w)) > 0:   # sym leaves Df zero
                assert rel(g, w) < TOL, name
            else:
                assert float(g.abs().max()) == 0.0, name
    assert rel(got.mse, want.mse) < TOL
    if sym:
        assert torch.equal(got.f, got.c.transpose(0, 1))


def test_coord_step_dp_at_b1_equals_coord_step():
    acts, ws = step_problem(5)
    a = [torch.from_numpy(t) for t in acts]
    w = [torch.from_numpy(t) for t in ws]
    z = tuple(torch.zeros_like(t) for t in w)
    one = tcoord.coord_step(*a, *w, z, z, tap_mode="ref_cpu")
    dp = tcoord.coord_step_dp(*(t[None] for t in a), *w, z, z,
                              tap_mode="ref_cpu")
    for name in ("c", "f", "b", "p"):
        assert torch.equal(getattr(one, name), getattr(dp, name)), name
    np.testing.assert_allclose(float(dp.mse), float(one.mse), rtol=1e-6)


@pytest.mark.parametrize("sym", [False, True])
def test_coord_step_dp_matches_jax(sym):
    acts, ws = step_problem(6, b=3)
    z = _zeros(ws)
    got = tcoord.coord_step_dp(*(torch.from_numpy(t) for t in acts + ws),
                               tuple(torch.from_numpy(t) for t in z),
                               tuple(torch.from_numpy(t) for t in z),
                               sym=sym)
    want = jcoord.coord_step_dp(*(jnp.asarray(t) for t in acts + ws),
                                tuple(jnp.asarray(t) for t in z),
                                tuple(jnp.asarray(t) for t in z), sym=sym)
    for name in ("c", "f", "b", "p", "mse"):
        assert rel(getattr(got, name), getattr(want, name)) < TOL, name
    for g, w in zip(got.prev_grad, want.prev_grad):
        if np.linalg.norm(np.asarray(w)) > 0:
            assert rel(g, w) < TOL


def test_coord_step_dp_with_axis_name_matches_jax(world):
    """The data-parallel step (``axis_name``: its gradients and mse
    pmean-ed over the axis, here of one rank) against JAX's step; the
    gloo meshes of two and four ranks are in tests/test_torch_dist.py."""
    acts, ws = step_problem(6, b=2)
    t = [torch.from_numpy(x) for x in acts + ws]
    z = tuple(torch.zeros_like(x) for x in t[3:])
    got = tcoord.coord_step_dp(*t, z, z, axis_name=world)
    jz = tuple(jnp.zeros_like(jnp.asarray(x)) for x in ws)
    want = jcoord.coord_step_dp(*(jnp.asarray(x) for x in acts + ws), jz,
                                jz)
    for name in ("c", "f", "b", "p", "mse"):
        assert rel(getattr(got, name), getattr(want, name)) < TOL, name
