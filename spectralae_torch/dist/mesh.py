"""The ``("data", "model")`` mesh over ranks, and data-parallel training.

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
  - ``model``: the burst precompute's resolution-sized work
    (:func:`spectralae_torch.train.fft_corr.corr_precompute_fused`, TP).

The model axis of the train step and of the forward (``stage_sharding``,
``shard_params``, ``shard_opt_state``, ``grid_sharding``,
``spatial_forward``, :func:`distributed_train_step` with ``n_model > 1``)
is ROADMAP A12b: in JAX these are sharding annotations that XLA
propagates; in PyTorch they need an M-sharded K1.  They raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from . import collectives

_A12B = ("the model axis of the train step and the forward needs an "
         "M-sharded K1: ROADMAP A12b")


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


def stage_sharding(mesh, stage):
    raise NotImplementedError(f"stage_sharding: {_A12B}")


def shard_params(params, mesh):
    raise NotImplementedError(f"shard_params: {_A12B}")


def shard_opt_state(opt, params, mesh):
    raise NotImplementedError(f"shard_opt_state: {_A12B}")


def grid_sharding(mesh):
    raise NotImplementedError(f"grid_sharding: {_A12B}")


def spatial_forward(mesh, scales, *, scale_by_dm: bool = True):
    raise NotImplementedError(f"spatial_forward: {_A12B}")


def distributed_train_step(mesh: Mesh):
    """The data-parallel train step on ``mesh``: the
    :func:`spectralae_torch.train.modern.train_step` of this rank's batch
    shard, its loss and gradients pmean-ed over ``data`` (one all_reduce)
    before the update, so every rank applies the same one.  The model axis
    is ROADMAP A12b: a mesh with ``n_model > 1`` raises."""
    if mesh.shape["model"] > 1:
        raise NotImplementedError(f"distributed_train_step on a "
                                  f"{mesh.shape['model']}-rank model axis: "
                                  f"{_A12B}")
    from ..train.modern import train_step
    data = mesh.axis("data")

    def step(params, opt, x, scales, *, lr=0.2, alpha=0.9, domain="fft",
             tap_mode="centered", scale_by_dm=True, train_pair=-1,
             active=False):
        collectives.check_shards(x.shape[0], data)
        return train_step(params, opt, x, scales, lr=lr, alpha=alpha,
                          domain=domain, tap_mode=tap_mode,
                          scale_by_dm=scale_by_dm, train_pair=train_pair,
                          active=active, axis_name=data)

    return step
