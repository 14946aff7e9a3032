"""Every collective of the port, issued in one place and logged.

The JAX package reduces with ``lax.pmean``, ``lax.psum`` and
``lax.all_gather`` over a named mesh axis inside ``shard_map``.  Here an
axis is a :class:`torch.distributed.ProcessGroup` (see
:mod:`spectralae_torch.dist.mesh`), and these functions issue the
collective over it:

- :func:`psum` / :func:`pmean`: one ``all_reduce(SUM)`` of all the given
  tensors packed into one flat float32 buffer (a pmean then divides by the
  group size, so the batch shards must be equal — :func:`check_shards`);
- :func:`all_gather`: one ``all_gather``, concatenated along dim 0 (JAX's
  ``all_gather(..., tiled=True)``).

None of these has a gradient.  Three autograd functions have explicit
adjoints, in the Megatron convention for a loss that every rank of the
axis computes whole (so the gradient of a tensor every rank holds alike
is alike on every rank); the model axis of the train step
(:mod:`spectralae_torch.dist.model_axis`) differentiates through
:func:`gather` and :func:`copy`; :func:`reduce`, the sum of partial
results (a contraction split over the ranks), completes the convention:

=================  ==========================  =========================
function           forward                     backward
=================  ==========================  =========================
:func:`gather`     all_gather along ``dim``    this rank's slice
:func:`copy`       identity                    all_reduce (sum)
:func:`reduce`     all_reduce (sum)            identity
=================  ==========================  =========================

``torch.distributed.nn.all_gather`` sums the gradient over the ranks in
its backward, which is wrong where the loss is replicated.  The backward's
collective goes through the same log as the forward's.

Complex tensors travel through :func:`torch.view_as_real` (NCCL and gloo
refuse complex).  Each call adds one to its op's count in :data:`CALLS`
and the real float32 elements it sent to :data:`ELEMENTS`, as the kernel
wrappers count their launches, and appends ``(op, elements)`` to
:data:`COLLECTIVES`, which keeps only the last :data:`LOG_LEN` (a long run
issues one or two a step); the tests read both.  A group of one rank still
issues its collective.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

#: collectives issued, and the float32 elements they sent, by op since
#: import (or the caller's last :func:`reset`)
CALLS = {"all_reduce": 0, "all_gather": 0}
ELEMENTS = {"all_reduce": 0, "all_gather": 0}
#: ``(op, elements)`` of the last LOG_LEN collectives, oldest first
LOG_LEN = 4096
COLLECTIVES: collections.deque[tuple[str, int]] = collections.deque(
    maxlen=LOG_LEN)


def reset() -> None:
    """Set every count to 0 and empty the log."""
    for op in CALLS:
        CALLS[op] = ELEMENTS[op] = 0
    COLLECTIVES.clear()


def _count(op: str, elements: int) -> None:
    CALLS[op] += 1
    ELEMENTS[op] += elements
    COLLECTIVES.append((op, elements))


def group(axis) -> dist.ProcessGroup:
    """``axis`` as the ProcessGroup it must be."""
    if not isinstance(axis, dist.ProcessGroup):
        raise TypeError(
            "axis_name/model_axis take the mesh axis's ProcessGroup "
            "(spectralae_torch.dist.mesh.Mesh.axis), not "
            f"{type(axis).__name__} {axis!r}")
    return axis


def axis_size(axis) -> int:
    """The number of ranks on ``axis`` (``lax.axis_size``)."""
    return dist.get_world_size(group(axis))


def axis_index(axis) -> int:
    """This rank's index on ``axis`` (``lax.axis_index``)."""
    return dist.get_rank(group(axis))


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return list(tree.values())
    return list(tree)


def _rebuild(tree, leaves):
    if torch.is_tensor(tree):
        return leaves[0]
    if isinstance(tree, dict):
        return dict(zip(tree, leaves))
    return type(tree)(leaves)


def psum(tree, axis):
    """Sum a tensor, or a list, tuple or dict of tensors, over ``axis`` in
    one all_reduce; returns the same structure of new tensors."""
    g = group(axis)
    leaves = _leaves(tree)
    parts = [torch.view_as_real(t) if t.is_complex() else t for t in leaves]
    for t in parts:
        if t.dtype != torch.float32:
            raise TypeError(f"psum/pmean take float32 or complex64 tensors, "
                            f"not {t.dtype}")
    flat = torch.cat([t.reshape(-1) for t in parts])
    _count("all_reduce", flat.numel())
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=g)
    out, at = [], 0
    for t, p in zip(leaves, parts):
        piece = flat[at:at + p.numel()].reshape(p.shape)
        at += p.numel()
        if t.is_complex():
            # a complex view needs an even offset: after an odd-sized real
            # leaf, the piece is copied
            piece = torch.view_as_complex(
                piece if piece.storage_offset() % 2 == 0 else piece.clone())
        out.append(piece)
    return _rebuild(tree, out)


def pmean(tree, axis):
    """:func:`psum` divided by the group size (``lax.pmean``)."""
    n = float(axis_size(axis))
    return _rebuild(tree, [t / n for t in _leaves(psum(tree, axis))])


def all_gather(t: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's ``t`` (alike in shape), concatenated along dim 0 in
    rank order."""
    g = group(axis)
    src = (torch.view_as_real(t) if t.is_complex() else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(g))]
    _count("all_gather", src.numel())
    dist.all_gather(parts, src, group=g)
    out = torch.cat(parts)
    return torch.view_as_complex(out) if t.is_complex() else out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim, ctx.size = axis, dim, t.shape[dim]
        out = all_gather(t.movedim(dim, 0).contiguous(), axis)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        at = axis_index(ctx.axis) * ctx.size
        return g.narrow(ctx.dim, at, ctx.size).contiguous(), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return psum(t.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather(t: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (alike in shape) concatenated along ``dim`` in
    rank order: one all_gather.  Backward: this rank's slice of the
    gradient, no collective (the gradient of the whole, which every rank
    computes alike, restricted to what this rank gave)."""
    return _Gather.apply(t, group(axis), dim % t.dim())


def copy(t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` itself, where every rank holds it alike and uses it for its
    own share of the work.  Backward: one all_reduce, which sums the
    ranks' partial gradients into the whole one."""
    return _Copy.apply(t, group(axis))


def reduce(t: torch.Tensor, axis) -> torch.Tensor:
    """The sum of every rank's ``t`` (alike in shape): one all_reduce.
    Backward: the identity (each rank's share enters the sum once, and the
    sum's gradient is alike on every rank)."""
    return _Reduce.apply(t, group(axis))


def check_shards(n: int, axis, what: str = "batch") -> None:
    """Raise unless every rank on ``axis`` holds ``n`` rows: a pmean of
    per-shard means is the global mean only over equal shards (JAX's
    sharding refuses a batch the axis does not divide).  One all_reduce
    (MAX) of ``[n, -n]``."""
    g = group(axis)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(g) == "nccl" else torch.device("cpu"))
    t = torch.tensor([n, -n], dtype=torch.float32, device=dev)
    _count("all_reduce", 2)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
    hi, lo = float(t[0]), -float(t[1])
    if hi != lo:
        raise ValueError(f"the {what} shards differ over the axis: "
                         f"{lo:g} to {hi:g} rows on its ranks")
