"""Rank side of tests/test_torch_dist.py: what each rank of a gloo mesh on
the CPU runs.  It imports torch and spectralae_torch only (the ranks never
import JAX); the test module builds the same inputs from the functions
here and runs the JAX package's distributed functions on them.
"""

import numpy as np
import pytest
import torch

# the burst problem: a global batch of B frames, sharded over 'data'
B, D, M, N, NK = 4, 2, 3, 16, 3
# the collectives' problem (the default net's widths; test_collectives.py)
C_D, C_M, C_NK = 3, 10, 5

# distributed_burst's bodies: (name, keywords)
BURSTS = (
    ("corr", dict(iters=5)),
    ("corr_maxdiff", dict(iters=5, maxdiff=True)),
    ("corr_reanchor", dict(iters=8, reanchor_every=3)),
    ("pallas", dict(iters=5, use_pallas=True)),
    ("omega", dict(iters=5, use_pallas=False)),
    ("fused_k4", dict(iters=5, fused=True, pallas_windows=True)),
    ("fused_plain", dict(iters=5, fused=True, pallas_windows=False)),
)


def burst_problem(seed: int = 1):
    """Frames ``[B, D, N, N]``, an anchor output, and one stage pair's
    weights, float32 numpy."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, D, N, N)).astype(np.float32) * 50
    out0 = (0.8 * xs + rng.normal(size=xs.shape) * 5).astype(np.float32)
    c = (rng.normal(size=(M, D, NK, NK)) * 0.3).astype(np.float32)
    f = (rng.normal(size=(D, M, NK, NK)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(M,)) * 0.1).astype(np.float32)
    p = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return xs, out0, c, f, b, p


def coord_problem(seed: int = 2):
    """A coord step's cropped (input, output, hidden) batch and weights."""
    rng = np.random.default_rng(seed)
    in_b = rng.normal(size=(B, D, N, N)).astype(np.float32) * 50
    out_b = (0.7 * in_b + rng.normal(size=in_b.shape) * 5).astype(np.float32)
    hin_b = rng.normal(size=(B, M, N, N)).astype(np.float32) * 20
    _, _, c, f, b, p = burst_problem(seed)
    return in_b, out_b, hin_b, c, f, b, p


def net_problem(seed: int = 3):
    """A two-pair net of the default widths at 16² (its spec from the
    port, weights from numpy), a global batch and a [K, B, 3, 16, 16]
    stream: ``(spec, [(c, b), ...], x, xs)``."""
    from spectralae_torch.core.config import Config, LayerParams
    from spectralae_torch.core.types import initial_spec
    cfg = Config(nx=16, ny=16, d=3,
                 layer=LayerParams(depth=4, lk=0, ll=0, scale=2, rmax=0.4))
    spec = initial_spec(cfg).add_pair(cfg.layer)
    rng = np.random.default_rng(seed)
    arrays = [((rng.uniform(-1, 1, (s.m, s.d, s.nk, s.nl)) * 0.4).astype(
        np.float32), (rng.uniform(-1, 1, s.m) * 0.1).astype(np.float32))
        for s in spec.stages]
    x = rng.uniform(0, 255, (B, 3, 16, 16)).astype(np.float32)
    xs = rng.normal(size=(2, B, 3, 16, 16)).astype(np.float32)
    return spec, arrays, x, xs


def collectives_problem(n: int, b: int, seed: int = 0):
    """test_collectives.py's burst input at n² (zero biases)."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(b, C_D, n, n)).astype(np.float32)
    c = rng.normal(size=(C_M, C_D, C_NK, C_NK)).astype(np.float32)
    f = rng.normal(size=(C_D, C_M, C_NK, C_NK)).astype(np.float32)
    return (xs, c, f, np.zeros(C_M, np.float32), np.zeros(C_D, np.float32))


def _np(r) -> dict:
    """A burst, step or stream result as a dict of numpy arrays."""
    out = {}
    for k, v in r._asdict().items():
        if torch.is_tensor(v):
            out[k] = v.numpy()
        elif k == "params":
            for i, s in enumerate(v.stages):
                out[f"c{i}"], out[f"b{i}"] = s.c.numpy(), s.b.numpy()
        elif k == "opt":
            out.update({f"{n}{i}": t.numpy() for n, a in
                        (("mom", v.mom), ("pg", v.prev_grad))
                        for i, t in enumerate(a.leaves())})
        else:
            out.update({f"{k}{i}": t.numpy() for i, t in enumerate(v)})
    return out


def run_mesh(rank: int, nd: int, nm: int) -> dict:
    """Every case on this rank of an ``nd x nm`` mesh; results by case."""
    from spectralae_torch.core.types import init_opt_state, params_from_numpy
    from spectralae_torch.dist import collectives, multihost
    from spectralae_torch.dist import mesh as dmesh
    from spectralae_torch.train.coord import distributed_coord_step
    from spectralae_torch.train.fft_dp import distributed_burst
    from spectralae_torch.train.streaming import coord_stream, stream_bursts
    mesh = dmesh.make_mesh(nd, nm)
    data = mesh.axis("data")
    out = {"multihost": dict(
        rank=multihost.process_index(), count=multihost.process_count(),
        coordinator=multihost.is_coordinator(), coords=mesh.coords)}
    try:
        dmesh.make_mesh(nd * nm + 1, 1)
    except ValueError as e:
        out["multihost"]["too_few"] = str(e)
    xs, out0, c, f, b, p = (torch.from_numpy(a) for a in burst_problem())
    x_l, o_l = dmesh.shard_batch(xs, mesh), dmesh.shard_batch(out0, mesh)
    out["multihost"]["local"] = tuple(
        multihost.local_batch_to_global(mesh, x_l.numpy()).shape)
    try:
        multihost.local_batch_to_global(mesh, xs[:mesh.coords[0] + 1])
        out["multihost"]["uneven"] = None
    except ValueError as e:
        out["multihost"]["uneven"] = str(e)
    for name, kw in BURSTS:
        run = distributed_burst(mesh, lr=0.2, **kw)
        r = (run(x_l, c, f, b, p) if kw.get("fused")
             else run(x_l, x_l, o_l, c, f, b, p))
        out[f"burst_{name}"] = _np(r)
    cp = [torch.from_numpy(a) for a in coord_problem()]
    acts = [dmesh.shard_batch(t, mesh) for t in cp[:3]]
    out["coord_step"] = _np(distributed_coord_step(mesh, lr=0.3)(
        *acts, *cp[3:]))
    spec, arrays, x, sx = net_problem()
    params = params_from_numpy(arrays)
    if nm == 1:
        out["train_step"] = _np(dmesh.distributed_train_step(mesh)(
            params, init_opt_state(params),
            dmesh.shard_batch(torch.from_numpy(x), mesh), spec.scales))
    else:
        try:
            dmesh.distributed_train_step(mesh)
        except NotImplementedError as e:
            out["train_step"] = str(e)
    sx = torch.from_numpy(sx)
    sx_l = sx[:, mesh.coords[0] * (B // nd):(mesh.coords[0] + 1) * (B // nd)]
    out["stream_bursts"] = _np(stream_bursts(
        sx_l[:, :, :D] * 50, c, f, b, p, iters=4, axis_name=data))
    out["coord_stream"] = _np(coord_stream(
        sx_l, params, spec.scales, 1, q=2, lr=0.3, axis_name=data))
    # the collectives of one fused burst (test_collectives.py's input):
    # on a data-only mesh at two resolutions, else on this mesh
    logs, counts = {}, {}
    sizes = (128, 256) if nm == 1 else (128,)
    routes = (None,) if nm == 1 else (None, False)
    for n in sizes:
        for route in routes:
            cx, cc, cf, cb, cpp = (torch.from_numpy(a) for a in
                                   collectives_problem(n, nd))
            collectives.reset()
            distributed_burst(mesh, lr=0.2, iters=1, fused=True,
                              pallas_windows=route)(
                dmesh.shard_batch(cx, mesh), cc, cf, cb, cpp)
            logs[(n, route)] = list(collectives.COLLECTIVES)
            counts[(n, route)] = (dict(collectives.CALLS),
                                  dict(collectives.ELEMENTS))
    out["collectives"] = logs
    out["collective_counts"] = counts
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """This process as a process group of one rank (gloo on the CPU, a
    FileStore in a temporary directory); yields the group, the axis of
    every one-rank mesh.  A test module imports it by name."""
    import torch.distributed as dist
    from spectralae_torch.dist import multihost
    store = tmp_path_factory.mktemp("pg") / "store"
    multihost.init_multihost(f"file://{store}", 1, 0, device="cpu",
                             timeout=60)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def fail_on_rank_one(rank: int) -> None:
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank one fails")
    dist.all_reduce(torch.ones(1))
