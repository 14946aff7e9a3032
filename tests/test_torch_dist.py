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
(test_tp_proof.py), streams rtol 2e-5 (test_streaming.py), the train
step 1e-5 and the coord step and stream 1e-5 norm-relative (the port's
parity tests of the single-device functions).  The collectives' log
mirrors test_collectives.py.
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
    res = spawn_ranks(worker.run_mesh, nd * nm, (nd, nm),
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


def test_distributed_train_step_matches_jax(ranks):
    """The data-axis step against JAX's on a data-only mesh; on a mesh
    with a model axis the step is ROADMAP A12b and raises."""
    nd, nm, res = ranks
    if nm > 1:
        assert "A12b" in res[0]["train_step"]
        return
    spec, arrays, x, _ = worker.net_problem()
    m = _jax_mesh(nd, nm)
    jp = jtypes.AEParams(stages=tuple(
        jtypes.ConvStage(c=jnp.asarray(c), b=jnp.asarray(b))
        for c, b in arrays))
    want = _jnp(jmesh.distributed_train_step(m)(
        jp, jtypes.init_opt_state(jp), jmesh.shard_batch(x, m),
        spec.scales))
    got = replicated(res, "train_step")
    assert set(got) == set(want)
    for k in want:
        assert rel(got[k], want[k]) < STEP_TOL, k


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


def test_model_axis_of_the_step_and_forward_is_a12b():
    one_by_two = tmesh.Mesh(1, 2, (0, 0), {})
    for call in (lambda: tmesh.stage_sharding(one_by_two, None),
                 lambda: tmesh.shard_params(None, one_by_two),
                 lambda: tmesh.shard_opt_state(None, None, one_by_two),
                 lambda: tmesh.grid_sharding(one_by_two),
                 lambda: tmesh.spatial_forward(one_by_two, (1,)),
                 lambda: tmesh.distributed_train_step(one_by_two)):
        with pytest.raises(NotImplementedError, match="A12b"):
            call()


def test_axes_take_process_groups():
    """The JAX axis names are not the port's axes, and a mesh needs the
    process group."""
    with pytest.raises(TypeError, match="ProcessGroup"):
        collectives.pmean(torch.ones(3), "data")
    with pytest.raises(RuntimeError, match="init_multihost"):
        tmesh.make_mesh(1, 1)


# (cards, LOCAL_WORLD_SIZE/LOCAL_RANK of torchrun, init_multihost's
# arguments) -> (the rank's device, the backend)
BACKEND_CASES = [
    (0, None, dict(num_processes=2, process_id=1), ("cpu", "gloo")),
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
    device, backend = want
    assert multihost.init_multihost("file:///unused", **kw) == backend
    assert calls["pg"] == backend
    assert calls.get("set") == (device if device != "cpu" else None)


def test_spawn_ranks_reports_a_failing_rank():
    """A rank that raises ends the run at once with its traceback, and the
    other rank, left waiting in a collective, is killed."""
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        spawn_ranks(worker.fail_on_rank_one, 2, timeout=60.0)
