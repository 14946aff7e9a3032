"""The ``("data", "model")`` mesh over ranks, and data- and
tensor-parallel training.

Port of :mod:`spectralae.dist.mesh`.  **The parallel model.**  The JAX
package builds a ``jax.sharding.Mesh`` with named axes and runs the
per-device body under ``shard_map``, reducing with ``lax.pmean``/``psum``/
``all_gather`` over an axis *name*.  The port is SPMD over
:mod:`torch.distributed`: every rank is one process that runs the same
function on its own batch shard; a mesh axis is the
:class:`~torch.distributed.ProcessGroup` of the ranks that share every
other coordinate, and the functions that take an axis keep the JAX
argument names (``axis_name`` for the data axis, ``model_axis``) and take
that group (:meth:`Mesh.axis`).  The collectives are issued by
:mod:`spectralae_torch.dist.collectives`, which logs each one.  A pmean is
an ``all_reduce(SUM)`` divided by the group size, so the batch shards must
be equal; the entry points here raise otherwise, as JAX's sharding does.

Rank ``r`` of an ``n_data x n_model`` mesh sits at data index
``r // n_model`` and model index ``r % n_model`` (the JAX package's
``reshape(n_data, n_model)`` of the device list).

Axes:
  - ``data``: the batch of frames (DP; gradients and the burst's lag
    tensors pmean-ed over it);
  - ``model``: the M output channels of each stage whose M it divides
    (:func:`shard_params`, the train step's TP), the spectra's grid rows
    (:func:`spatial_forward`), and the burst precompute's
    resolution-sized work
    (:func:`spectralae_torch.train.fft_corr.corr_precompute_fused`).

The JAX package's model axis is sharding annotations that XLA propagates.
Here a rank holds its slices (:class:`ShardedParams`: each stage's
:class:`StageSharding` beside the leaves), the step and the forward issue
their collectives through the autograd functions of
:mod:`spectralae_torch.dist.collectives`, from the per-stage conv hooks of
:mod:`spectralae_torch.dist.model_axis`, which says which, and of what
size.
:func:`gather_params` and :func:`gather_opt_state` give back the whole
``AEParams`` (``np.asarray`` of a JAX global array): what a checkpoint of a
sharded run saves.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core.types import AEParams, ConvStage, OptState
from . import collectives


class Mesh:
    """A ``("data", "model")`` mesh of ranks: its shape, this rank's
    coordinates and the process group of each axis through this rank."""

    axis_names = ("data", "model")

    def __init__(self, n_data: int, n_model: int, coords: tuple[int, int],
                 groups: dict):
        self.shape = {"data": n_data, "model": n_model}
        self.coords = coords
        self._groups = groups

    def axis(self, name: str) -> dist.ProcessGroup:
        """The process group of axis ``name`` through this rank."""
        if name not in self._groups:
            raise KeyError(f"mesh axes are {self.axis_names}, not {name!r}")
        return self._groups[name]


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """Build a ``("data", "model")`` mesh over the ranks of the default
    process group (:func:`~spectralae_torch.dist.multihost.init_multihost`
    first).  Every rank must call it, with the same arguments: it creates
    one process group per row and column of the mesh.  Ranks past
    ``n_data * n_model`` take part in the creation and hold no mesh (they
    get None)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "spectralae_torch.dist.multihost.init_multihost "
                           "first")
    world = dist.get_world_size()
    if n_data is None:
        # max(1, ...): n_model above the rank count would otherwise give
        # n_data = 0 and skip the error below
        n_data = max(1, world // n_model)
    need = n_data * n_model
    if world < need:
        raise ValueError(
            f"make_mesh needs {need} ranks for a {n_data}x{n_model} "
            f"(data, model) mesh but only {world} are available. Start "
            f"{need} processes (init_multihost with num_processes={need}); "
            "on one card or on the CPU they share the gloo backend.")
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in the same order
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank < need and rank % n_model == m:
            groups["data"] = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank < need and rank // n_model == d:
            groups["model"] = g
    if rank >= need:
        return None
    return Mesh(n_data, n_model, (rank // n_model, rank % n_model), groups)


class BatchSharding(NamedTuple):
    """Frames ``[B, D, H, W]`` split over the data axis: this rank holds
    shard ``index`` of ``shards`` equal ones (JAX's ``P("data", ...)``)."""
    index: int
    shards: int


def batch_sharding(mesh: Mesh) -> BatchSharding:
    return BatchSharding(mesh.coords[0], mesh.shape["data"])


def shard_batch(x, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a global batch ``x`` (every rank holds it):
    rows ``index·B/n .. (index+1)·B/n``.  Raises where the data axis does
    not divide the batch."""
    x = torch.as_tensor(x)
    idx, n = batch_sharding(mesh)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"{n} equal shards over the data axis")
    per = x.shape[0] // n
    return x[idx * per:(idx + 1) * per]


class StageSharding(NamedTuple):
    """Where a stage's kernels lie on this rank: output channels
    ``index·m/shards .. (index+1)·m/shards`` of the stage's ``m`` (the
    whole stage's M) — ``c[m/shards, D, nk, nl]`` and ``b[m/shards]`` —
    where the model axis divides M; else the whole stage (``index`` 0,
    ``shards`` 1).  A local shape cannot tell a sharded stage of M from a
    whole one of M/n: this record can."""
    index: int
    shards: int
    m: int

    @property
    def channels(self) -> slice:
        per = self.m // self.shards
        return slice(self.index * per, (self.index + 1) * per)


@dataclasses.dataclass
class ShardedParams:
    """This rank's slices of an :class:`AEParams` (``params``) and each
    stage's :class:`StageSharding` (``layout``)."""
    params: AEParams
    layout: tuple[StageSharding, ...]


def stage_layout(mesh: Mesh, m: int) -> StageSharding:
    """The sharding of a stage of ``m`` output channels on this rank: over
    the model axis where it divides ``m``, else whole (JAX's
    ``_stage_shardings``)."""
    n = mesh.shape["model"]
    if n > 1 and m % n == 0:
        return StageSharding(mesh.coords[1], n, m)
    return StageSharding(0, 1, m)


def _slice(stage: ConvStage, lay: StageSharding) -> ConvStage:
    if lay.shards == 1:
        return stage
    sl = lay.channels
    return ConvStage(c=stage.c[sl].clone(), b=stage.b[sl].clone())


def _shard(tree: AEParams, layout) -> ShardedParams:
    for s, lay in zip(tree.stages, layout):
        if s.m != lay.m:
            raise ValueError(f"a stage of {s.m} output channels where the "
                             f"layout has {lay.m}: shard whole trees")
    return ShardedParams(AEParams(stages=tuple(
        _slice(s, lay) for s, lay in zip(tree.stages, layout))), layout)


def stage_sharding(mesh: Mesh, stage: ConvStage) -> ConvStage:
    """This rank's slice of a whole stage: c ``[M/n, D, nk, nl]`` and b
    ``[M/n]`` where the model axis divides M, else the stage itself."""
    return _slice(stage, stage_layout(mesh, stage.m))


def _layout(params: AEParams, mesh: Mesh) -> tuple[StageSharding, ...]:
    return tuple(stage_layout(mesh, s.m) for s in params.stages)


def shard_params(params: AEParams, mesh: Mesh) -> ShardedParams:
    """This rank's slices of ``params`` (every rank holds them whole):
    replicated over data, M-sharded over model where divisible."""
    return _shard(params, _layout(params, mesh))


def shard_opt_state(opt: OptState, params: AEParams, mesh: Mesh) -> OptState:
    """The whole optimizer state of the whole ``params``, laid out as
    :func:`shard_params` lays them out: momentum and previous gradient
    each a :class:`ShardedParams`."""
    layout = _layout(params, mesh)
    return OptState(mom=_shard(opt.mom, layout),
                    prev_grad=_shard(opt.prev_grad, layout))


def gather_params(sharded: ShardedParams, mesh: Mesh) -> AEParams:
    """The whole :class:`AEParams` of every rank's slices, on every rank:
    one all_gather over the model axis of all sharded leaves packed
    together (none where no stage is sharded)."""
    parts = [t for s, lay in zip(sharded.params.stages, sharded.layout)
             if lay.shards > 1 for t in (s.c, s.b)]
    if not parts:
        return sharded.params
    n = mesh.shape["model"]
    flat = collectives.all_gather(torch.cat([t.reshape(-1) for t in parts]),
                                  mesh.axis("model")).reshape(n, -1)
    pieces, at = [], 0
    for t in parts:
        pieces.append(flat[:, at:at + t.numel()].reshape(
            (n * t.shape[0],) + tuple(t.shape[1:])))
        at += t.numel()
    whole = iter(pieces)
    return AEParams(stages=tuple(
        ConvStage(c=next(whole), b=next(whole)) if lay.shards > 1 else s
        for s, lay in zip(sharded.params.stages, sharded.layout)))


def gather_opt_state(opt: OptState, mesh: Mesh) -> OptState:
    """:func:`gather_params` of the momentum and the previous gradient."""
    return OptState(mom=gather_params(opt.mom, mesh),
                    prev_grad=gather_params(opt.prev_grad, mesh))


class GridSharding(NamedTuple):
    """Spectra ``[B, C, Nx, Nyr]`` with the grid rows split over the model
    axis: this rank holds slab ``index`` of ``shards`` equal ones (JAX's
    ``P(None, None, "model", None)``)."""
    index: int
    shards: int

    def rows(self, nx: int) -> slice | None:
        """This rank's rows of a grid of ``nx`` rows, or None where the
        stage stays whole: the axis does not divide ``nx`` (JAX's
        ``constrain`` keeps such a spectrum local), or has one rank."""
        if self.shards == 1 or nx % self.shards:
            return None
        per = nx // self.shards
        return slice(self.index * per, (self.index + 1) * per)


def grid_sharding(mesh: Mesh) -> GridSharding:
    """This rank's slab of the frequency grid's rows — spatial parallelism
    for resolutions whose working set exceeds one card's memory."""
    return GridSharding(mesh.coords[1], mesh.shape["model"])


def spatial_forward(mesh: Mesh, scales, *, scale_by_dm: bool = True):
    """The momentum-space forward with each stage's pointwise conv (K1 on
    the card) on this rank's slab of grid rows
    (:func:`spectralae_torch.dist.model_axis.row_conv`): the FFTs and the
    pooling run whole, one all_gather a stage joins the rows.  Returns
    ``fwd(params, x)``: ``params`` whole (:func:`gather_params` of a
    sharded run's), ``x`` this rank's batch shard; the reconstruction of
    ``x``, whole on every rank of the model axis.  A forward only: no
    gradient."""
    from ..model.autoencoder import forward_fft
    from .model_axis import row_conv
    conv = row_conv(grid_sharding(mesh), mesh.axis("model"))

    @torch.no_grad()
    def fwd(params: AEParams, x):
        return forward_fft(params, x, scales, scale_by_dm=scale_by_dm,
                           stage_conv=conv)

    return fwd


def distributed_train_step(mesh: Mesh):
    """The train step on ``mesh``:
    :func:`spectralae_torch.train.modern.train_step` of this rank's batch
    shard, the loss and the gradients pmean-ed over ``data`` (one
    all_reduce) before the update, so every rank of a model index applies
    the same one.

    It takes :class:`ShardedParams` and their state (:func:`shard_params`,
    :func:`shard_opt_state`): each stage's conv runs on the rank's slice
    (:func:`spectralae_torch.dist.model_axis.stage_conv`, whose docstring
    lists the collectives of a step), the update on the rank's slices, and
    the result comes back sharded alike.  On a model axis of one rank every
    stage is whole, and it also takes whole :class:`AEParams` and their
    state: the step is the data-axis one, bit for bit.
    ``step(params, opt, x, scales, *, lr, alpha, domain, tap_mode,
    scale_by_dm, train_pair, active)``, as in the JAX package.
    """
    from ..train import modern
    from .model_axis import stage_conv
    data, model = mesh.axis("data"), mesh.axis("model")

    def step(params, opt, x, scales, *, lr=0.2, alpha=0.9, domain="fft",
             tap_mode="centered", scale_by_dm=True, train_pair=-1,
             active=False):
        kw = dict(lr=lr, alpha=alpha, domain=domain, tap_mode=tap_mode,
                  scale_by_dm=scale_by_dm, train_pair=train_pair,
                  active=active)
        sharded = isinstance(params, ShardedParams)
        if not sharded and mesh.shape["model"] > 1:
            raise TypeError("a model axis of more than one rank takes "
                            "ShardedParams and their state (shard_params, "
                            "shard_opt_state)")
        collectives.check_shards(x.shape[0], data)
        if not sharded:
            return modern.train_step(params, opt, x, scales,
                                     axis_name=data, **kw)
        lay = params.layout
        r = modern.train_step(
            params.params, OptState(opt.mom.params, opt.prev_grad.params),
            x, scales, axis_name=data, stage_conv=stage_conv(lay, model),
            **kw)
        return modern.TrainStepResult(
            params=ShardedParams(r.params, lay),
            opt=OptState(mom=ShardedParams(r.opt.mom, lay),
                         prev_grad=ShardedParams(r.opt.prev_grad, lay)),
            loss=r.loss)

    return step
