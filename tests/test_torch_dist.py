"""The port's data- and tensor-parallel training on gloo ranks (CPU).

A module fixture starts the ranks of each mesh shape once — (2, 1) data
parallel, (1, 2) tensor parallel, (2, 2) both — as processes of the
``spawn`` method over a FileStore, each with one torch thread, with a
timeout of 180 s on the rendezvous, on every collective and on the whole
run (``spectralae_torch.dist.multihost.spawn_ranks``): a rank that raises
or hangs fails the fixture with its traceback.  The ranks import torch and
the port only (tests/torch_dist_worker.py); JAX runs here, in the parent,
on the same shape of the 8-device virtual CPU mesh (tests/conftest.py),
from the same numpy inputs.  Every rank's replicated result must be the
same bit for bit.

Tolerances are the JAX tests' own: the DP bursts rtol 1e-4 / atol 1e-5
(test_fft_dp.py), the fused TP burst rtol 3e-5 / atol 1e-6
(test_tp_proof.py), streams rtol 2e-5 (test_streaming.py), the model
axis's ten steps rtol 1e-4 and spatial_forward rtol 1e-5 / atol 1e-4
(test_modern_dist.py), the train step (data and model axes) 1e-5 and the
coord step and stream 1e-5 norm-relative (the port's parity tests of the
single-device functions).  The collectives' log mirrors
test_collectives.py; the model axis's is held to the plan of
spectralae_torch.dist.model_axis (``step_collectives``,
``forward_collectives``), itself held to one case written out by hand.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_dist_worker as worker
from spectralae.core import types as jtypes
from spectralae.dist import mesh as jmesh
from spectralae_torch.dist import collectives
from spectralae_torch.dist import mesh as tmesh
from spectralae_torch.dist.multihost import spawn_ranks
from spectralae_torch.train import fft_dp as tdp

torch.set_num_threads(1)

MESHES = [(2, 1), (1, 2), (2, 2)]
SPAWN_TIMEOUT = 180.0
DP_TOL = dict(rtol=1e-4, atol=1e-5)
TP_TOL = dict(rtol=3e-5, atol=1e-6)
STEP_TOL = 1e-5


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"mesh{d}x{m}" for d, m in MESHES])
def ranks(request):
    """``(n_data, n_model, [each rank's results])``."""
    nd, nm = request.param
    res = spawn_ranks(worker.run_mesh, nd * nm, (nd, nm), device="cpu",
                      timeout=SPAWN_TIMEOUT)
    return nd, nm, res


def replicated(res, case) -> dict:
    """Rank 0's result of ``case``, after checking every rank's is the
    same bit for bit."""
    first = res[0][case]
    for r in res[1:]:
        assert set(r[case]) == set(first)
        for k in first:
            assert np.array_equal(r[case][k], first[k]), (case, k)
    return first


def _jnp(r) -> dict:
    """A JAX result as the rank side's dict (torch_dist_worker._np)."""
    out = {}
    for k, v in r._asdict().items():
        if k == "params":
            for i, s in enumerate(v.stages):
                out[f"c{i}"], out[f"b{i}"] = np.asarray(s.c), np.asarray(s.b)
        elif k == "opt":
            for n, a in (("mom", v.mom), ("pg", v.prev_grad)):
                out.update({f"{n}{i}": np.asarray(t) for i, t in enumerate(
                    jax.tree.leaves(a))})
        elif isinstance(v, (tuple, list)):
            out.update({f"{k}{i}": np.asarray(t) for i, t in enumerate(v)})
        else:
            out[k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _jax_mesh(nd, nm):
    assert len(jax.devices()) == 8
    return jmesh.make_mesh(nd, nm)


@functools.lru_cache(maxsize=None)
def _jax_burst(nd, nm, name):
    from spectralae.train.fft_dp import distributed_burst
    kw = dict(worker.BURSTS)[name]
    m = _jax_mesh(nd, nm)
    xs, out0, c, f, b, p = worker.burst_problem()
    run = distributed_burst(m, lr=0.2, **kw)
    xs_s = jmesh.shard_batch(xs, m)
    r = (run(xs_s, c, f, b, p) if kw.get("fused")
         else run(xs_s, xs_s, jmesh.shard_batch(out0, m), c, f, b, p))
    return _jnp(r)


# ----------------------------------------------------- distributed_burst

@pytest.mark.parametrize("name", [n for n, _ in worker.BURSTS])
def test_distributed_burst_matches_jax(ranks, name):
    """Every body of ``distributed_burst`` on the mesh: the corr burst
    (with ``maxdiff``, with ``reanchor_every``), the ω-space bodies
    (``use_pallas=True``: K5/K7's plain versions; ``False``: the einsum
    body), and ``fused=True`` with ``pallas_windows=True`` (K4, on row
    slabs under a model axis) and ``False`` (the plain TP pipeline)."""
    nd, nm, res = ranks
    got = replicated(res, f"burst_{name}")
    want = _jax_burst(nd, nm, name)
    tol = TP_TOL if nm > 1 and name.startswith("fused") else DP_TOL
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_distributed_coord_step_matches_jax(ranks):
    from spectralae.train.coord import distributed_coord_step
    nd, nm, res = ranks
    got = replicated(res, "coord_step")
    m = _jax_mesh(nd, nm)
    in_b, out_b, hin_b, c, f, b, p = worker.coord_problem()
    want = _jnp(distributed_coord_step(m, lr=0.3)(
        *(jmesh.shard_batch(a, m) for a in (in_b, out_b, hin_b)),
        c, f, b, p))
    assert set(got) == set(want)
    for k in want:
        if np.linalg.norm(want[k]) > 0:
            assert rel(got[k], want[k]) < STEP_TOL, k


def _jparams(arrays):
    return jtypes.AEParams(stages=tuple(
        jtypes.ConvStage(c=jnp.asarray(c), b=jnp.asarray(b))
        for c, b in arrays))


def test_distributed_train_step_matches_jax(ranks):
    """The step against JAX's on every mesh: on a data-only mesh the
    whole parameters, with a model axis their slices (gathered back), as
    JAX's step of ``shard_params`` is."""
    nd, nm, res = ranks
    spec, arrays, x, _ = worker.net_problem()
    m = _jax_mesh(nd, nm)
    jp = _jparams(arrays)
    want = _jnp(jmesh.distributed_train_step(m)(
        jmesh.shard_params(jp, m),
        jmesh.shard_opt_state(jtypes.init_opt_state(jp), jp, m),
        jmesh.shard_batch(x, m), spec.scales))
    got = replicated(res, "train_step" if nm == 1 else "train_step_sharded")
    assert set(got) == set(want)
    for k in want:
        assert rel(got[k], want[k]) < STEP_TOL, k


# the one mesh whose model axis has one rank (the module fixture's first)
@pytest.mark.parametrize("ranks", [pytest.param(MESHES[0], id="mesh2x1")],
                         indirect=True)
def test_model_axis_of_one_rank_is_the_data_step(ranks):
    """Sharded parameters on a model axis of one rank take the data-axis
    step, bit for bit.  (On a wider axis there is no data-axis step of the
    whole parameters; the gathered result is what the test above holds
    against JAX.)"""
    _, nm, res = ranks
    assert nm == 1
    got = replicated(res, "train_step_sharded")
    want = replicated(res, "train_step")
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# ------------------------------------------------------ the model axis

TP_CASES = [(name, domain) for name, _ in worker.TP_NETS
            for domain in ("fft", "coord")]


@functools.lru_cache(maxsize=None)
def _jax_tp_step(nd, nm, name, domain):
    spec, arrays, x = worker.tp_problem(**dict(worker.TP_NETS)[name])
    m = _jax_mesh(nd, nm)
    jp = _jparams(arrays)
    sp = jmesh.shard_params(jp, m)
    return _jnp(jmesh.distributed_train_step(m)(
        sp, jmesh.shard_opt_state(jtypes.init_opt_state(jp), sp, m),
        jmesh.shard_batch(x, m), spec.scales, domain=domain))


@pytest.mark.parametrize("name,domain", TP_CASES,
                         ids=[f"{n}-{d}" for n, d in TP_CASES])
def test_model_axis_step_matches_jax(ranks, name, domain):
    """One step of each TP_NETS net in both domains: the gathered
    parameters, momentum, previous gradient and loss, alike on every rank
    bit for bit, against JAX's ``distributed_train_step`` on
    ``shard_params`` of the same mesh shape (test_modern_dist.py)."""
    nd, nm, res = ranks
    got = replicated(res, f"tp_{name}_{domain}")
    want = _jax_tp_step(nd, nm, name, domain)
    assert set(got) == set(want)
    for k in want:
        assert rel(got[k], want[k]) < STEP_TOL, k


@pytest.mark.parametrize("name,domain", TP_CASES,
                         ids=[f"{n}-{d}" for n, d in TP_CASES])
def test_model_axis_slices_concatenate_to_jax(ranks, name, domain):
    """Each rank's own slices (its layout: output channels ``index·M/n``
    of a sharded stage, the whole of any other) concatenate over the model
    axis to JAX's global arrays; a whole stage is the same on every
    rank."""
    nd, nm, res = ranks
    want = _jax_tp_step(nd, nm, name, domain)
    for d in range(nd):
        row = [res[d * nm + m] for m in range(nm)]
        for i in range(len(row[0][f"tp_layout_{name}"])):
            layouts = [r[f"tp_layout_{name}"][i] for r in row]
            shards = layouts[0][1]
            assert [lay[0] for lay in layouts] == (
                list(range(nm)) if shards > 1 else [0] * nm)
            for k in (f"c{i}", f"b{i}", f"mom{2 * i}", f"mom{2 * i + 1}"):
                parts = [r[f"tp_local_{name}_{domain}"][k] for r in row]
                if shards == 1:
                    assert all(np.array_equal(p, parts[0]) for p in parts)
                    parts = parts[:1]
                assert rel(np.concatenate(parts), want[k]) < STEP_TOL, k


@functools.lru_cache(maxsize=None)
def _jax_single_steps():
    from spectralae.train.modern import train_step
    spec, arrays, x = worker.tp_problem(**dict(worker.TP_NETS)[
        "sharded_out"], batch=2 * worker.B)
    params = _jparams(arrays)
    opt = jtypes.init_opt_state(params)
    losses = []
    for _ in range(worker.TP_STEPS):
        r = train_step(params, opt, jnp.asarray(x), spec.scales,
                       lr=worker.TP_LR, domain="fft")
        params, opt = r.params, r.opt
        losses.append(float(r.loss))
    return np.array(losses)


def test_model_axis_ten_steps_match_single_device(ranks):
    """test_modern_dist.py:61-86 on the port: ten fft steps of the
    d = 2, m = 4 net (its last stage sharded too) on the mesh; the loss
    falls and matches the single-device step's, JAX's and the port's, at
    rtol 1e-4."""
    _, _, res = ranks
    got = replicated(res, "tp_steps")
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], _jax_single_steps(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["losses"], got["single"], rtol=1e-4,
                               atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_spatial(nd, nm, name):
    """JAX's spatial_forward on the mesh shape, or with ``nd = nm = 0``
    the single-device forward."""
    from spectralae.model import autoencoder as jmodel
    spec, arrays, x = worker.tp_problem(**dict(worker.SPATIAL_NETS)[name])
    jp = _jparams(arrays)
    if nd == 0:
        return np.asarray(jmodel.forward_fft(jp, jnp.asarray(x),
                                             spec.scales))
    m = _jax_mesh(nd, nm)
    return np.asarray(jmesh.spatial_forward(m, spec.scales)(
        jmesh.shard_params(jp, m), jmesh.shard_batch(x, m)))


@pytest.mark.parametrize("name", [n for n, _ in worker.SPATIAL_NETS])
def test_spatial_forward_matches_jax(ranks, name):
    """test_modern_dist.py:190-206 on the port: the forward with the
    grid rows over the model axis, alike on every rank bit for bit,
    against JAX's ``spatial_forward`` on the same mesh shape and the
    single-device forward, at rtol 1e-5 / atol 1e-4."""
    nd, nm, res = ranks
    got = replicated(res, f"spatial_{name}")["out"]
    for want in (_jax_spatial(nd, nm, name), _jax_spatial(0, 0, name)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_step_collectives_by_hand():
    """model_axis.step_collectives, which the test below holds the log
    to, on the "net" TP_NETS net (16², two pairs, D = 3, M = 4, 3×3 taps)
    at n = 2 and a batch shard of 2, written out by hand from the module
    docstring: stages 0-2 sharded, the 4 → 3 last one whole."""
    from spectralae_torch.dist import model_axis
    spec = worker.tp_problem(**dict(worker.TP_NETS)["net"])[0]
    assert [(s.d, s.m, s.nx, s.ny, s.nk) for s in spec.stages] == [
        (3, 4, 8, 8, 3), (4, 4, 4, 4, 3), (4, 4, 4, 4, 3), (4, 3, 8, 8, 3)]
    fft = [("all_gather", 2 * 2 * 4 * 3 * 2),   # stage 1's input
           ("all_gather", 2 * 2 * 4 * 3 * 2),   # stage 2's
           ("all_gather", 2 * 2 * 8 * 5 * 2),   # stage 3's
           ("all_reduce", 2 * 4 * 4 * 3 * 2),   # stage 1's dX
           ("all_reduce", 2 * 4 * 4 * 3 * 2),   # stage 2's dX
           ("all_reduce", 2),                   # the batch shards' check
           # the loss and the local gradients: 3 stages of 2 channels, a
           # whole one of 3, each channel D·9 taps and a bias
           ("all_reduce", 1 + 2 * 28 + 2 * 37 + 2 * 37 + 3 * 37)]
    assert model_axis.step_collectives(spec, 2, 2, "fft") == sorted(fft)
    rows = [("all_gather", 2 * 4 * 4 * 5 * 2),  # stage 0's 8 rows, 4 each
            ("all_gather", 2 * 4 * 2 * 3 * 2),
            ("all_gather", 2 * 4 * 2 * 3 * 2),
            ("all_gather", 2 * 3 * 4 * 5 * 2)]
    assert model_axis.forward_collectives(spec, 2, 2) == sorted(rows)


COLLECTIVE_CASES = TP_CASES + [(n, "spatial") for n, _ in
                               worker.SPATIAL_NETS]


@pytest.mark.parametrize("name,kind", COLLECTIVE_CASES,
                         ids=[f"{n}-{k}" for n, k in COLLECTIVE_CASES])
def test_model_axis_collectives_match_the_docstring(ranks, name, kind):
    """The collectives of one step (each domain) and of one
    spatial_forward, read from the log on every rank, are those the
    docstring of spectralae_torch.dist.model_axis states."""
    from spectralae_torch.dist import model_axis
    nd, nm, res = ranks
    nets = dict(worker.TP_NETS) | dict(worker.SPATIAL_NETS)
    spec = worker.tp_problem(**nets[name])[0]
    b = worker.B // nd
    want = (model_axis.forward_collectives(spec, nm, b) if kind == "spatial"
            else model_axis.step_collectives(spec, nm, b, kind))
    for r in res:
        assert sorted(r["tp_collectives"][(name, kind)]) == want


@pytest.mark.parametrize("name", ["gather", "gather_complex", "copy",
                                  "reduce"])
def test_autograd_collectives_adjoints(ranks, name):
    """Each autograd collective over the model axis (one rank or two):
    its forward, and its input's gradient under a linear loss against the
    adjoint written out by hand; one logged collective, in the forward
    (gather, reduce) or the backward (copy)."""
    _, nm, res = ranks
    for r in res:
        rank = r["multihost"]["coords"][1]
        got = r["adjoints"][name]
        t, z = worker.adjoint_problem(rank)
        w_g, wz, w_c, w_r = worker.adjoint_weights(nm, rank)
        every = [worker.adjoint_problem(k) for k in range(nm)]
        if name == "gather":
            y = np.concatenate([e[0] for e in every], axis=1)
            grad = w_g[:, 3 * rank:3 * rank + 3]
            logs = ([("all_gather", t.size)], [])
        elif name == "gather_complex":
            y = np.concatenate([e[1] for e in every], axis=0)
            grad = wz[2 * rank:2 * rank + 2]
            logs = ([("all_gather", 2 * z.size)], [])
        elif name == "copy":
            y = t
            grad = sum(worker.adjoint_weights(nm, k)[2] for k in range(nm))
            logs = ([], [("all_reduce", t.size)])
        else:
            y = sum(e[0] for e in every)
            grad = w_r
            logs = ([("all_reduce", t.size)], [])
        np.testing.assert_array_equal(got["y"], y)
        np.testing.assert_allclose(got["grad"], grad, rtol=1e-6)
        assert (got["forward"], got["backward"]) == logs


# --------------------------------------------------------------- streams

def _jax_on_data(fn, m, xs, *rest):
    """``fn(xs, *rest)`` under shard_map with ``xs``'s axis 1 (the
    frames' batch) over 'data'."""
    sharded = shard_map(fn, mesh=m,
                        in_specs=(P(None, "data"),) + (P(),) * len(rest),
                        out_specs=P(), check_vma=False)
    return jax.jit(sharded)(xs, *rest)


def test_stream_bursts_with_axis_name_matches_jax(ranks):
    from spectralae.train.streaming import stream_bursts
    nd, nm, res = ranks
    got = replicated(res, "stream_bursts")
    _, _, c, f, b, p = worker.burst_problem()
    _, _, _, sx = worker.net_problem()
    r = _jax_on_data(lambda xs, c_, f_, b_, p_: tuple(stream_bursts(
        xs, c_, f_, b_, p_, iters=4, axis_name="data")), _jax_mesh(nd, nm),
        sx[:, :, :worker.D] * 50, c, f, b, p)
    want = dict(zip(("c", "f", "b", "p"), map(np.asarray, r[:4])))
    want.update({f"mom{i}": np.asarray(t) for i, t in enumerate(r[4])})
    want["mses"] = np.asarray(r[5])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6,
                                   err_msg=k)


def test_coord_stream_with_axis_name_matches_jax(ranks):
    from spectralae.train.streaming import stream_coord_steps
    nd, nm, res = ranks
    got = replicated(res, "coord_stream")
    spec, arrays, _, sx = worker.net_problem()
    jp = jtypes.AEParams(stages=tuple(
        jtypes.ConvStage(c=jnp.asarray(c), b=jnp.asarray(b))
        for c, b in arrays))
    r = _jax_on_data(lambda xs, pp: stream_coord_steps(
        xs, pp, spec.scales, 1, q=2, lr=0.3, axis_name="data"),
        _jax_mesh(nd, nm), sx, jp)
    want = _jnp(r)
    assert set(got) == set(want)
    for k in want:
        if np.linalg.norm(want[k]) > 0:
            assert rel(got[k], want[k]) < STEP_TOL, k


# ------------------------------------------------------------ multihost

def test_multihost_runtime(ranks):
    """``init_multihost`` joined every rank; ``process_index``,
    ``process_count``, ``is_coordinator``, the mesh coordinates,
    ``local_batch_to_global`` (and its refusal of uneven shards), and
    ``make_mesh``'s refusal of a mesh larger than the ranks."""
    nd, nm, res = ranks
    world = nd * nm
    for rank, r in enumerate(res):
        mh = r["multihost"]
        assert mh["rank"] == rank and mh["count"] == world
        assert mh["coordinator"] == (rank == 0)
        assert mh["coords"] == (rank // nm, rank % nm)
        assert mh["local"] == (worker.B // nd, worker.D, worker.N, worker.N)
        if nd > 1:
            assert "shards differ" in mh["uneven"]
        else:
            assert mh["uneven"] is None
        assert f"needs {world + 1} ranks" in mh["too_few"]


# ---------------------------------------------------------- collectives

def _payload_elems(d=worker.C_D, nk=worker.C_NK):
    """The T dict's elements (test_collectives.py::_expected_payload_elems):
    XX at ±4h, XE0 and XG0 at ±2h, three scalars and three [D] vectors."""
    h = nk // 2
    return d * d * (8 * h + 1) ** 2 + 2 * d * d * (4 * h + 1) ** 2 + 3 * d + 3


def test_dp_burst_collectives_are_window_sized(ranks):
    """A data-only mesh: every collective of a fused burst is an
    all_reduce of at most the T dict's size, and their total is the same
    at 128² and 256² (nothing resolution-sized crosses the ranks); with a
    model axis the data axis's all_reduce is still the T dict."""
    nd, nm, res = ranks
    budget = _payload_elems()
    logs = res[0]["collectives"]
    if nm > 1:
        # with a model axis, the data axis still moves one T dict
        for log in logs.values():
            assert ("all_reduce", budget) in log, log
        return
    for (n, _), log in logs.items():
        assert log, "the DP burst must reduce its lag tensors"
        for op, elems in log:
            assert op == "all_reduce" and elems <= budget, (n, log)
        assert sum(e for _, e in log) <= 2 * budget
    assert (sum(e for _, e in logs[(128, None)])
            == sum(e for _, e in logs[(256, None)]))


def test_tp_burst_single_resolution_sized_gather(ranks):
    """With a model axis the only resolution-sized collective of a fused
    burst is ONE all_gather of the signal half-spectra (this rank's share
    of the B·D planes), on the K4 row-slab route and the plain one; a
    data-only mesh gathers nothing."""
    nd, nm, res = ranks
    if nm == 1:
        # no model axis: nothing is gathered
        assert all(op == "all_reduce" for log in res[0]["collectives"].values()
                   for op, _ in log)
        return
    n, b_local = 128, 1
    planes = -(-b_local * worker.C_D // nm)        # this rank's share
    gather = planes * n * (n // 2 + 1) * 2          # complex as 2 floats
    for (_, route), log in res[0]["collectives"].items():
        big = [(op, e) for op, e in log if e > 4 * _payload_elems()]
        assert big == [("all_gather", gather)], (route, log)


def test_collective_counts_match_the_log(ranks):
    """``CALLS`` and ``ELEMENTS`` count by op what the log lists."""
    _, _, res = ranks
    for r in res:
        for key, log in r["collectives"].items():
            calls, elems = r["collective_counts"][key]
            for op in calls:
                assert calls[op] == sum(o == op for o, _ in log), key
                assert elems[op] == sum(e for o, e in log if o == op), key


def test_collectives_log_is_bounded(tmp_path, monkeypatch):
    """A long run keeps its counts but only the last ``LOG_LEN``
    collectives in the log (one rank over gloo, the real collectives)."""
    import collections
    import torch.distributed as dist
    from spectralae_torch.dist import multihost
    monkeypatch.setattr(collectives, "LOG_LEN", 16)
    monkeypatch.setattr(collectives, "COLLECTIVES",
                        collections.deque(maxlen=16))
    multihost.init_multihost(f"file://{tmp_path}/store", 1, 0,
                             device="cpu", timeout=60)
    try:
        collectives.reset()
        for _ in range(20):
            collectives.psum([torch.ones(3), torch.ones(2, 2,
                              dtype=torch.complex64)], dist.group.WORLD)
        collectives.all_gather(torch.ones(2, 5), dist.group.WORLD)
        assert collectives.CALLS == {"all_reduce": 20, "all_gather": 1}
        assert collectives.ELEMENTS == {"all_reduce": 20 * 11,
                                        "all_gather": 10}
        assert list(collectives.COLLECTIVES) == (
            [("all_reduce", 11)] * 15 + [("all_gather", 10)])
        collectives.reset()
        assert not any(collectives.CALLS.values())
        assert not any(collectives.ELEMENTS.values())
        assert not collectives.COLLECTIVES
    finally:
        dist.destroy_process_group()


# ---------------------------------------------- checks and refusals

def test_distributed_burst_checks_its_arguments():
    """JAX's argument checks (fft_dp.py:195-205), before any rank is
    touched."""
    with pytest.raises(ValueError, match="reanchor_every"):
        tdp.distributed_burst(None, reanchor_every=3, use_pallas=True)
    with pytest.raises(ValueError, match="fused"):
        tdp.distributed_burst(None, fused=True, use_pallas=False)
    with pytest.raises(ValueError, match="pallas_windows"):
        tdp.distributed_burst(None, pallas_windows=True)


def test_model_axis_layouts():
    """``stage_layout`` shards a stage over the model axis where the axis
    divides its M (JAX's ``_stage_shardings``), and ``GridSharding`` gives
    a rank its slab of rows where the axis divides them; ``stage_sharding``
    and ``shard_params`` slice, ``shard_opt_state`` lays the state out
    alike.  A model axis of more than one rank takes ShardedParams."""
    from spectralae_torch.core.types import (AEParams, ConvStage,
                                             init_opt_state)
    second = tmesh.Mesh(1, 2, (0, 1), {"data": None, "model": None})
    assert tmesh.stage_layout(second, 10) == (1, 2, 10)
    assert tmesh.stage_layout(second, 10).channels == slice(5, 10)
    assert tmesh.stage_layout(second, 3) == (0, 1, 3)
    assert tmesh.stage_layout(tmesh.Mesh(2, 1, (1, 0), {}), 10) == (0, 1,
                                                                    10)
    grid = tmesh.grid_sharding(second)
    assert grid == (1, 2) and grid.rows(16) == slice(8, 16)
    assert grid.rows(3) is None
    assert tmesh.GridSharding(0, 1).rows(16) is None
    c = torch.arange(10 * 3 * 4, dtype=torch.float32).reshape(10, 3, 2, 2)
    params = AEParams(stages=(ConvStage(c=c, b=torch.arange(10.)),
                              ConvStage(c=c[:3, :, :, :].clone(),
                                        b=torch.arange(3.))))
    half = tmesh.stage_sharding(second, params.stages[0])
    assert torch.equal(half.c, c[5:]) and torch.equal(half.b,
                                                      torch.arange(5., 10.))
    sp = tmesh.shard_params(params, second)
    assert sp.layout == ((1, 2, 10), (0, 1, 3))
    assert sp.params.stages[1] is params.stages[1]
    opt = tmesh.shard_opt_state(init_opt_state(params), params, second)
    for tree in (opt.mom, opt.prev_grad):
        assert tree.layout == sp.layout
        assert [t.shape for t in tree.params.leaves()] == [
            t.shape for t in sp.params.leaves()]
    with pytest.raises(ValueError, match="shard whole trees"):
        tmesh.shard_opt_state(init_opt_state(sp.params), params, second)
    with pytest.raises(TypeError, match="ShardedParams"):
        tmesh.distributed_train_step(second)(
            params, init_opt_state(params), torch.zeros(1, 3, 8, 8), (2, -2))


def test_axes_take_process_groups():
    """The JAX axis names are not the port's axes, and a mesh needs the
    process group."""
    with pytest.raises(TypeError, match="ProcessGroup"):
        collectives.pmean(torch.ones(3), "data")
    with pytest.raises(RuntimeError, match="init_multihost"):
        tmesh.make_mesh(1, 1)


# (cards, LOCAL_WORLD_SIZE/LOCAL_RANK of torchrun, init_multihost's
# arguments) -> (the rank's device, the backend), or None where it raises
BACKEND_CASES = [
    # no card and no device: no fallback to the CPU
    (0, None, dict(num_processes=2, process_id=1), None),
    # two hosts of eight cards: rank 11 is the fourth of its host
    (8, None, dict(num_processes=16, process_id=11), ("cuda:3", "nccl")),
    (8, ("8", "3"), dict(), ("cuda:3", "nccl")),
    (4, None, dict(num_processes=4, process_id=2, device="cuda"),
     ("cuda:2", "nccl")),
    # two ranks on one card: gloo
    (1, None, dict(num_processes=2, process_id=1, local_processes=2),
     ("cuda:0", "gloo")),
    (2, ("4", "3"), dict(), ("cuda:1", "gloo")),
    # a card shared on purpose, on a host with enough of them
    (4, None, dict(num_processes=2, process_id=1, local_processes=2,
                   device="cuda:0", backend="gloo"), ("cuda:0", "gloo")),
    (4, None, dict(num_processes=2, process_id=0, device="cpu"),
     ("cpu", "gloo")),
]


@pytest.mark.parametrize("cards,env,kw,want", BACKEND_CASES)
def test_init_multihost_picks_the_card_and_backend(monkeypatch, cards, env,
                                                    kw, want):
    """The rank's card follows its local index, and NCCL is chosen
    whenever each rank of the host has a card of its own, whatever the
    world size (torch.distributed and the card count patched)."""
    import torch.distributed as dist
    from spectralae_torch.dist import multihost
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("set", str(d)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **k: calls.setdefault("pg", backend))
    for name, value in zip(("LOCAL_WORLD_SIZE", "LOCAL_RANK"), env or ()):
        monkeypatch.setenv(name, value)
    if env is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    if want is None:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            multihost.init_multihost("file:///unused", **kw)
        assert "pg" not in calls
        return
    device, backend = want
    assert multihost.init_multihost("file:///unused", **kw) == backend
    assert calls["pg"] == backend
    assert calls.get("set") == (device if device != "cpu" else None)


def test_spawn_ranks_reports_a_failing_rank():
    """A rank that raises ends the run at once with its traceback, and the
    other rank, left waiting in a collective, is killed."""
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        spawn_ranks(worker.fail_on_rank_one, 2, device="cpu", timeout=60.0)


def test_spawn_ranks_raises_without_a_card(monkeypatch):
    """With no device given and no card, spawn_ranks raises before it
    starts a rank (no fallback to the CPU); device="cpu" is the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        spawn_ranks(worker.fail_on_rank_one, 2, timeout=60.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        spawn_ranks(worker.fail_on_rank_one, 2, device="cuda", timeout=60.0)
