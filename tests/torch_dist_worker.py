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


# the model axis's nets: (name, tp_problem keywords).  "net": two pairs,
# D = 3, M = 4 at 16² (at n = 2 stages 0-2 sharded, the 4 → 3 last one
# whole after a sharded one, as the default net's 10 → 3); "sharded_out":
# test_modern_dist.py's one pair d = 2, m = 4 (the last stage sharded
# too); "whole": a one-pair net whose M = 3 a model axis of two divides
# nowhere
TP_NETS = (("net", dict(d=3, m=4, lk=0, pairs=2)),
           ("sharded_out", dict(d=2, m=4, lk=0, pairs=1)),
           ("whole", dict(d=3, m=3, lk=0, pairs=1)))
# test_modern_dist.py:61-86: ten fft steps at lr 0.5 of the sharded_out net
TP_STEPS, TP_LR = 10, 0.5
# spatial_forward's nets: test_modern_dist.py:190-206's 32² two-pair net
# (every stage's rows divide), and a 24² three-pair one whose innermost
# grid (3 rows) stays whole
SPATIAL_NETS = (("rows32", dict(nx=32, d=2, m=4, lk=1, pairs=2)),
                ("rows24", dict(nx=24, d=2, m=4, lk=0, pairs=3)))


def tp_problem(nx: int = 16, d: int = 3, m: int = 4, lk: int = 0,
               pairs: int = 2, batch: int = B, seed: int = 4):
    """A net of ``pairs`` stage pairs (its spec from the port, weights
    from numpy) and a global batch: ``(spec, [(c, b), ...], x)``."""
    from spectralae_torch.core.config import Config, LayerParams
    from spectralae_torch.core.types import initial_spec
    cfg = Config(nx=nx, ny=nx, d=d, layer=LayerParams(
        depth=m, lk=lk, ll=lk, scale=2, rmax=0.5))
    spec = initial_spec(cfg)
    for _ in range(pairs - 1):
        spec = spec.add_pair(cfg.layer)
    rng = np.random.default_rng(seed)
    arrays = [((rng.uniform(-1, 1, (s.m, s.d, s.nk, s.nl)) * 0.5).astype(
        np.float32), (rng.uniform(-1, 1, s.m) * 0.5).astype(np.float32))
        for s in spec.stages]
    x = (rng.normal(size=(batch, d, nx, nx)) * 20).astype(np.float32)
    return spec, arrays, x


def adjoint_problem(rank: int):
    """The autograd collectives' inputs on a rank: a real ``[2, 3]`` and a
    complex ``[2, 2]`` tensor, each different on every rank."""
    t = np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * rank
    z = (np.arange(4).reshape(2, 2) + 1j * (rank + 1)).astype(np.complex64)
    return t, z


def adjoint_weights(n: int, rank: int):
    """The weights of the linear losses the collectives' outputs enter, on
    a rank of ``n``: ``(w_gather [2, 3n], wz_gather [2n, 2] complex,
    w_copy [2, 3], different on every rank, w_reduce [2, 3])``."""
    w_g = np.linspace(-1, 1, 6 * n, dtype=np.float32).reshape(2, 3 * n)
    wz = (np.linspace(-1, 1, 4 * n) + 0.5j).astype(np.complex64).reshape(
        2 * n, 2)
    w_c = np.full((2, 3), rank + 1.5, np.float32)
    w_r = np.linspace(2, 3, 6, dtype=np.float32).reshape(2, 3)
    return w_g, wz, w_c, w_r


def _adjoints(axis) -> dict:
    """Each autograd collective's forward and its input's gradient under a
    linear loss, with the log of each (forward, then backward)."""
    from spectralae_torch.dist import collectives as col
    n, rank = col.axis_size(axis), col.axis_index(axis)
    t0, z0 = (torch.from_numpy(a) for a in adjoint_problem(rank))
    w_g, wz, w_c, w_r = (torch.from_numpy(a)
                         for a in adjoint_weights(n, rank))
    out = {}
    for name, src, fn, w in (
            ("gather", t0, lambda t: col.gather(t, axis, dim=1), w_g),
            ("gather_complex", z0, lambda t: col.gather(t, axis), wz),
            ("copy", t0, lambda t: col.copy(t, axis), w_c),
            ("reduce", t0, lambda t: col.reduce(t, axis), w_r)):
        t = src.clone().requires_grad_()
        col.reset()
        y = fn(t)
        forward_log = list(col.COLLECTIVES)
        col.reset()
        # a real loss, linear in y: its gradient in y is w
        loss = (torch.real(torch.sum(w.conj() * y)) if y.is_complex()
                else torch.sum(w * y))
        loss.backward()
        out[name] = dict(y=y.detach().numpy(), grad=t.grad.numpy(),
                         forward=forward_log,
                         backward=list(col.COLLECTIVES))
    return out


def _tp_cases(mesh, out: dict) -> None:
    """The model axis of the step and the forward on this rank: each
    TP_NETS net a step in both domains (sharded, stepped, gathered back),
    TP_STEPS steps of the sharded_out net, and spatial_forward of each
    SPATIAL_NETS net, each with the collectives it issued."""
    from spectralae_torch.core.types import (OptState, init_opt_state,
                                             params_from_numpy)
    from spectralae_torch.dist import collectives
    from spectralae_torch.dist import mesh as dmesh
    from spectralae_torch.train.modern import TrainStepResult, train_step
    step = dmesh.distributed_train_step(mesh)
    logs = {}
    for name, kw in TP_NETS:
        spec, arrays, x = tp_problem(**kw)
        params = params_from_numpy(arrays)
        sp = dmesh.shard_params(params, mesh)
        out[f"tp_layout_{name}"] = [tuple(lay) for lay in sp.layout]
        for domain in ("fft", "coord"):
            so = dmesh.shard_opt_state(init_opt_state(params), params, mesh)
            collectives.reset()
            r = step(sp, so, dmesh.shard_batch(torch.from_numpy(x), mesh),
                     spec.scales, domain=domain)
            logs[(name, domain)] = list(collectives.COLLECTIVES)
            out[f"tp_local_{name}_{domain}"] = _np(TrainStepResult(
                params=r.params.params, opt=OptState(
                    r.opt.mom.params, r.opt.prev_grad.params),
                loss=r.loss))
            out[f"tp_{name}_{domain}"] = _np(TrainStepResult(
                params=dmesh.gather_params(r.params, mesh),
                opt=dmesh.gather_opt_state(r.opt, mesh), loss=r.loss))
    spec, arrays, x = tp_problem(**dict(TP_NETS)["sharded_out"],
                                 batch=2 * B)
    params = params_from_numpy(arrays)
    sp = dmesh.shard_params(params, mesh)
    so = dmesh.shard_opt_state(init_opt_state(params), params, mesh)
    x_l = dmesh.shard_batch(torch.from_numpy(x), mesh)
    single, sopt = params, init_opt_state(params)
    losses, single_losses = [], []
    for _ in range(TP_STEPS):
        r = step(sp, so, x_l, spec.scales, lr=TP_LR)
        sp, so = r.params, r.opt
        losses.append(float(r.loss))
        s = train_step(single, sopt, torch.from_numpy(x), spec.scales,
                       lr=TP_LR)
        single, sopt = s.params, s.opt
        single_losses.append(float(s.loss))
    out["tp_steps"] = dict(losses=np.array(losses),
                           single=np.array(single_losses))
    for name, kw in SPATIAL_NETS:
        spec, arrays, x = tp_problem(**kw)
        fwd = dmesh.spatial_forward(mesh, spec.scales)
        collectives.reset()
        y = fwd(params_from_numpy(arrays),
                dmesh.shard_batch(torch.from_numpy(x), mesh))
        logs[(name, "spatial")] = list(collectives.COLLECTIVES)
        # every batch shard's reconstruction on every rank
        out[f"spatial_{name}"] = {"out": collectives.all_gather(
            y, mesh.axis("data")).numpy()}
    out["tp_collectives"] = logs
    out["adjoints"] = _adjoints(mesh.axis("model"))


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
        if v is None:       # a step's div without maxdiff
            continue
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
    from spectralae_torch.train.modern import TrainStepResult
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
    step = dmesh.distributed_train_step(mesh)
    x_l = dmesh.shard_batch(torch.from_numpy(x), mesh)
    # the model axis: sharded in, sharded out, gathered back; on a model
    # axis of one rank also the step of the whole AEParams
    r = step(dmesh.shard_params(params, mesh),
             dmesh.shard_opt_state(init_opt_state(params), params, mesh),
             x_l, spec.scales)
    out["train_step_sharded"] = _np(TrainStepResult(
        params=dmesh.gather_params(r.params, mesh),
        opt=dmesh.gather_opt_state(r.opt, mesh), loss=r.loss))
    if nm == 1:
        out["train_step"] = _np(step(params, init_opt_state(params), x_l,
                                     spec.scales))
    _tp_cases(mesh, out)
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
