"""The model axis of the train step and of the forward.

Port of what the JAX package leaves to sharding propagation when
``spectralae.dist.mesh`` shards each stage's kernels over M and the
spectra's grid rows over the ``model`` axis.  Here every collective, its
gradient and every kernel launch on a slice is written out; the ranks of
the axis are the :class:`~torch.distributed.ProcessGroup` ``axis``.  Both
are hooks of the one forward
(:func:`spectralae_torch.model.autoencoder.forward_fft`, ``forward_coord``:
``stage_conv``), which runs everything but the convs as on one rank.

**The train step** (:func:`stage_conv`, behind
:func:`spectralae_torch.dist.mesh.distributed_train_step`).  A stage whose
M the axis divides holds output channels ``index·M/n ..`` of ``c`` and
``b`` (:class:`~spectralae_torch.dist.mesh.StageSharding`); any other
stage is whole on every rank.  The output of a sharded stage is split over
the axis by channels; pooling, in either domain, runs on what the rank
holds.  Each stage:

- takes its input whole: an all_gather along the channels where the stage
  before it is sharded;
- **sharded**: the conv of the rank's slice of ``c`` on that input,
  through :func:`~collectives.copy` (K1 or K2 at the local M, the scale
  ``1/M`` and K2's route taken from the whole stage); a split output,
  gathered at once where it is the last stage, so that the loss sees the
  whole reconstruction;
- **whole**: the stage as on one rank, alike on every rank.

A whole stage after a sharded one (the default net's 10 → 3 last stage at
n = 2) gathers its input, as every stage does, rather than contracting
the rank's input channels and summing the partial outputs: one path for
every stage and both domains, no collective in its backward, and right
under an activation ``act``.  It costs ``[B, D/n, …]`` a rank where the
sum's all_reduce would move ``[B, M, …]`` and, backward, ``c``'s
gradient: 5 channels against 3 at the default net's last stage.

So one step of an n-rank axis issues, over ``model`` (complex tensors
count two floats an element; ``[B, C, X, Y]`` at the stage's conv grid,
B this rank's batch shard, D and M a stage's input and output channels):

- forward: one all_gather of ``[B, D/n, X, Y]`` for each stage after a
  sharded one, and one of ``[B, M/n, X, Y]`` where the last stage is
  sharded;
- backward: one all_reduce of ``[B, D, X, Y]`` for each sharded stage but
  stage 0 (whose input, the frames, carries no gradient);

and then, over ``data``, the step's one check of the batch shards (two
floats) and one all_reduce of the loss and of this rank's gradients
(:func:`spectralae_torch.train.modern.train_step`'s ``axis_name``):
:func:`step_collectives`.  The default net (D = 3, M = 10, three pairs) at
n = 2: 5 all_gathers forward, 4 all_reduces backward.  Each gradient of a
slice is exact and local; the whole stages' gradients are alike on every
rank.

**The forward over grid rows** (:func:`row_conv`, behind
:func:`spectralae_torch.dist.mesh.spatial_forward`).  Every rank holds the
whole spectrum ("the 2-D FFT itself needs whole transform axes"): the
``rfft2``, the spectral pooling and the ``irfft2`` run whole.  A stage
whose grid rows the axis divides runs K1 on the rank's slab of rows of X
and of the kernel spectra, with the bias only on the slab holding row 0,
and one all_gather of ``[B, M, X/n, Y]`` joins the rows; any other stage
runs whole (:func:`forward_collectives`).
"""

from __future__ import annotations

from . import collectives


def stage_conv(layout, axis):
    """The forward's ``stage_conv`` hook for a rank's slices of a net laid
    out as ``layout`` (each stage's
    :class:`~spectralae_torch.dist.mesh.StageSharding`) on the model axis
    ``axis``: its input is this rank's batch shard, whole on every rank of
    the axis, and so is the reconstruction."""
    last = len(layout) - 1

    def conv_on_axis(i, X, k, b, conv):
        if i and layout[i - 1].shards > 1:
            X = collectives.gather(X, axis, dim=1)
        lay = layout[i]
        if lay.shards == 1:
            return conv(X, k, b)
        Y = conv(collectives.copy(X, axis), k, b, m_global=lay.m)
        return collectives.gather(Y, axis, dim=1) if i == last else Y

    return conv_on_axis


def row_conv(grid, axis):
    """The momentum-space forward's ``stage_conv`` hook that runs each
    stage's pointwise conv on this rank's slab of grid rows (``grid``,
    :class:`~spectralae_torch.dist.mesh.GridSharding`) and gathers the
    rows over ``axis``; every parameter whole."""
    def conv_on_rows(i, X, C, b, conv):
        rows = grid.rows(X.shape[-2])
        if rows is None:
            return conv(X, C, b)
        Y = conv(X[:, :, rows], C[:, :, rows],
                 b if rows.start == 0 else None)
        return collectives.gather(Y, axis, dim=2)

    return conv_on_rows


def _grid(s, fft: bool) -> int:
    """The real floats of one channel of stage ``s``'s conv input."""
    return s.nx * ((s.ny // 2 + 1) * 2 if fft else s.ny)


def step_collectives(spec, n: int, batch: int, domain: str) -> list:
    """The collectives of one step as the module docstring states them,
    ``[(op, elements), ...]`` sorted: a net of ``spec``
    (:class:`~spectralae_torch.core.types.NetSpec`) on a model axis of
    ``n`` ranks, a batch shard of ``batch``, the ``domain``'s grids."""
    fft = domain == "fft"
    log, local = [], 0
    stages = spec.stages
    sharded = [n > 1 and s.m % n == 0 for s in stages]
    for i, s in enumerate(stages):
        if i and sharded[i - 1]:
            log.append(("all_gather", batch * s.d // n * _grid(s, fft)))
        if sharded[i] and i:
            log.append(("all_reduce", batch * s.d * _grid(s, fft)))
        local += (s.m // n if sharded[i] else s.m) * (s.d * s.nk * s.nl + 1)
    if sharded[-1]:
        s = stages[-1]
        log.append(("all_gather", batch * s.m // n * _grid(s, fft)))
    return sorted(log + [("all_reduce", 2), ("all_reduce", 1 + local)])


def forward_collectives(spec, n: int, batch: int) -> list:
    """The collectives of one ``spatial_forward`` call, sorted: one
    all_gather of ``[batch, M, X/n, Y]`` for each stage whose grid rows
    the axis of ``n`` ranks divides."""
    if n == 1:
        return []
    return sorted(("all_gather", batch * s.m * s.nx // n * (s.ny // 2 + 1)
                   * 2) for s in spec.stages if s.nx % n == 0)
