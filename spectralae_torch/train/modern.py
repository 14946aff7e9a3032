"""Batched whole-network training — the production path.

Port of :mod:`spectralae.train.modern`.  The reference trains one stage pair
at a time on a single frame.  This path generalizes to: batched frames, all
stages trained jointly (or a selected pair via ``train_pair``), gradients by
autograd through the full forward in either domain — through the
hand-written kernels' backward passes on the card
(:class:`~spectralae_torch.ops.spectral_kernels.SpectralConvFused`,
:class:`~spectralae_torch.ops.coord_kernels.ConvValid`) — and the
reference's normalized-gradient inertia optimizer.  Two of the reference's
objectives ride on the step (``sym``, ``maxdiff``): the 'p' tie of each
decoder stage to its encoder's transposed kernels, and the 'm'
kernel-diversity objective.

Every step is functional, as in the JAX package: it returns new parameter
and optimizer-state tensors and updates none of those it was given, so a
caller may keep an earlier step's tensors (the CLI's divergence rollback, an
asynchronous checkpoint save) while training goes on.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from ..core import profiling
from ..core.types import AEParams, ConvStage, OptState
from ..losses.losses import stage_diversity
from ..model import autoencoder as model
from ..ops.spectral_kernels import check_compute_dtype
from ..optim.update import tree_update


class TrainStepResult(NamedTuple):
    params: AEParams
    opt: Any            # OptState, or an Optimizer's state
    loss: torch.Tensor  # 0-d, on the device; reading it synchronises
    #: with ``maxdiff``, the diversity term each stage's gradient lost,
    #: ``w1·g_div`` (zeros on a stage ``train_pair`` leaves out); else None
    div: AEParams | None = None


def reconstruction_loss(params: AEParams, x: torch.Tensor, scales, *,
                        domain: str = "fft", tap_mode: str = "centered",
                        scale_by_dm: bool = True, act=None,
                        compute_dtype=None, remat: bool = False,
                        stage_conv=None, sym: bool = False) -> torch.Tensor:
    """½·mean squared reconstruction error over the batch.

    ``compute_dtype=torch.bfloat16`` is the JAX package's mixed-precision
    path: in the fft domain the FFTs stay float32 and the pointwise convs
    stream bf16 operands with float32 sums; in the coord domain the params
    and the input are cast to bf16 here, inside the loss, so the gradients
    reach the float32 leaves.  The target is the float32 input in both.
    ``act`` applies only in the coordinate domain (the spectral forward is
    linear by construction; the reference's activation is identity there
    too, backproplib.cu:38-44).  ``remat`` checkpoints per-stage blocks and
    ``stage_conv`` runs each stage's conv and ``sym`` ties each decoder
    stage to its encoder's ``cᵀ`` (see the forwards' docstrings).
    """
    check_compute_dtype(compute_dtype)
    x32 = x.to(torch.float32)
    if domain == "fft":
        out = model.forward_fft(params, x, scales, scale_by_dm=scale_by_dm,
                                compute_dtype=compute_dtype, remat=remat,
                                stage_conv=stage_conv, sym=sym)
    else:
        if compute_dtype is not None:
            params = AEParams.from_leaves([t.to(compute_dtype)
                                           for t in params.leaves()])
            x = x.to(compute_dtype)
        out = model.forward_coord(params, x, scales, tap_mode=tap_mode,
                                  scale_by_dm=scale_by_dm, act=act,
                                  remat=remat, stage_conv=stage_conv,
                                  sym=sym)[-1]
    return 0.5 * torch.mean((out.to(torch.float32) - x32) ** 2)


def _loss_and_grads(params: AEParams, x: torch.Tensor, scales, **loss_kw):
    """``(loss, grads)`` of :func:`reconstruction_loss` at ``params``; the
    parameters are differentiated through fresh leaves, never modified.
    A leaf the forward does not read (a tied decoder's ``c``) gets a zero
    gradient.  The spans ``forward`` and ``backward``."""
    leaves = [t.detach().requires_grad_() for t in params.leaves()]
    with profiling.span("forward"):
        loss = reconstruction_loss(AEParams.from_leaves(leaves), x, scales,
                                   **loss_kw)
    with profiling.span("backward"):
        grads = torch.autograd.grad(loss, leaves,
                                    allow_unused=loss_kw["sym"])
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(leaves, grads)]
    return loss.detach(), AEParams.from_leaves(grads)


def _accumulated_loss_and_grads(params, x, scales, accum_steps, **loss_kw):
    """Loss and grads microbatched over ``accum_steps`` sequential chunks.

    Peak activation memory stays at one chunk's worth while the average is
    (numerically) the full-batch gradient.
    """
    b = x.shape[0]
    if b % accum_steps:
        raise ValueError(
            f"batch {b} not divisible by accum_steps {accum_steps}")
    xs = x.reshape(accum_steps, b // accum_steps, *x.shape[1:])
    lsum = torch.zeros((), dtype=torch.float32, device=x.device)
    gsum = [torch.zeros_like(t, dtype=torch.float32)
            for t in params.leaves()]
    for xc in xs:
        loss, grads = _loss_and_grads(params, xc, scales, **loss_kw)
        lsum = lsum + loss
        gsum = [s + g.to(torch.float32) for s, g in zip(gsum, grads.leaves())]
    inv = 1.0 / accum_steps
    return lsum * inv, AEParams.from_leaves([t * inv for t in gsum])


def _mask_grads(grads: AEParams, params: AEParams,
                train_pair: int) -> AEParams:
    """Zero gradients of all but the selected encoder/decoder stage pair —
    the reference's per-layer training focus (autoencoder.cpp:161-201)."""
    n = params.n_stages
    stages = []
    for i, g in enumerate(grads.stages):
        keep = i == train_pair or i == n - 1 - train_pair
        stages.append(g if keep else dataclasses.replace(
            g, c=torch.zeros_like(g.c), b=torch.zeros_like(g.b)))
    return AEParams(stages=tuple(stages))


def _grads(params, x, scales, accum_steps, train_pair, loss_kw):
    if accum_steps > 1:
        loss, grads = _accumulated_loss_and_grads(params, x, scales,
                                                  accum_steps, **loss_kw)
    else:
        loss, grads = _loss_and_grads(params, x, scales, **loss_kw)
    grads = AEParams.from_leaves([g.to(torch.float32)
                                  for g in grads.leaves()])
    if train_pair >= 0:
        grads = _mask_grads(grads, params, train_pair)
    return loss, grads


def _fold(grads: AEParams) -> AEParams:
    """The 'p' tie's gradients (``backprop_gpu_cc``, backproplib.cu:533,
    as :func:`spectralae_torch.train.coord._apply_update` folds them):
    each pair's kernels ``½(dc + dfᵀ)``, its decoder's the transpose of
    that, and both its biases' gradients halved.  The span ``tie``."""
    with profiling.span("tie"):
        n = grads.n_stages
        stages = list(grads.stages)
        for p in range(n // 2):
            enc, dec = grads.pair(p)
            gc = 0.5 * (enc.c + dec.c.transpose(0, 1))
            stages[p] = ConvStage(c=gc, b=0.5 * enc.b)
            stages[n - 1 - p] = ConvStage(c=gc.transpose(0, 1),
                                          b=0.5 * dec.b)
    return AEParams(stages=tuple(stages))


def _combine(params: AEParams, grads: AEParams, train_pair: int,
             sym: bool, w0: float, w1: float):
    """The 'm' objective (fft_backproplib.cu:1252): each kept stage's
    gradient becomes ``w0·g − w1·g_div``, ``g_div`` the repulsion of its
    kernels and of its biases at the weights going into the step
    (:func:`~spectralae_torch.losses.losses.stage_diversity`).  With
    ``sym`` a tied decoder's kernels take their encoder's term, transposed.
    Returns the combined gradients and the ``w1·g_div`` taken off them."""
    n = params.n_stages
    gs, ds = list(grads.stages), []
    for i, (st, g) in enumerate(zip(params.stages, grads.stages)):
        if train_pair >= 0 and i not in (train_pair, n - 1 - train_pair):
            ds.append(ConvStage(c=torch.zeros_like(g.c),
                                b=torch.zeros_like(g.b)))
            continue
        tied = sym and i >= n // 2
        cd, bd = stage_diversity(None if tied else st.c, st.b)
        db = w1 * bd
        if tied:
            enc_g, enc_d = gs[n - 1 - i], ds[n - 1 - i]
            gs[i] = ConvStage(c=enc_g.c.transpose(0, 1), b=w0 * g.b - db)
            ds.append(ConvStage(c=enc_d.c.transpose(0, 1), b=db))
        else:
            dc = w1 * cd
            gs[i] = ConvStage(c=w0 * g.c - dc, b=w0 * g.b - db)
            ds.append(ConvStage(c=dc, b=db))
    return AEParams(stages=tuple(gs)), AEParams(stages=tuple(ds))


def _retie(params: AEParams) -> AEParams:
    """Each decoder stage's kernels set to its encoder's transposed
    (``f ← cᵀ``, backproplib.cu:622), contiguous; biases stay.  The span
    ``tie``."""
    with profiling.span("tie"):
        for p in range(params.n_pairs):
            enc, dec = params.pair(p)
            params = params.replace_pair(
                p, enc, ConvStage(c=enc.c.transpose(0, 1).contiguous(),
                                  b=dec.b))
    return params


def train_step(params: AEParams, opt: OptState, x: torch.Tensor,
               scales: tuple, *, lr: float = 0.2, alpha: float = 0.9,
               domain: str = "fft", tap_mode: str = "centered",
               scale_by_dm: bool = True, train_pair: int = -1,
               active: bool = False, act=None,
               compute_dtype=None, remat: bool = False,
               accum_steps: int = 1, axis_name=None,
               stage_conv=None, sym: bool = False, maxdiff: bool = False,
               w0: float = 1.0, w1: float = 10.0) -> TrainStepResult:
    """One batched train step with the reference's inertia optimizer.

    Args:
      x: ``[B, D, Nx, Ny]`` batch of frames.
      scales: per-stage pooling scales (NetSpec.scales).
      train_pair: ``-1`` trains all stages; ``n`` trains only pair ``n``.
      remat: per-stage rematerialization (memory for recompute).
      accum_steps: gradient accumulation over ``accum_steps`` microbatches
        (batch must divide evenly); one optimizer update per call.
      axis_name: the data axis's process group
        (:func:`spectralae_torch.dist.mesh.distributed_train_step`): ``x``
        is this rank's batch shard, and the loss and gradients are
        pmean-ed over the axis before the update.
      stage_conv: the forward's per-stage conv hook
        (:func:`spectralae_torch.model.autoencoder.forward_fft`): with the
        model axis's (:func:`spectralae_torch.dist.model_axis.stage_conv`)
        ``params`` and ``opt`` are a rank's slices, and so is the step's
        result.
      sym: the reference's 'p' tie (autoencoder.cpp:343-355,
        ``backprop_gpu_cc``): the forward reads each decoder's kernels as
        its encoder's ``cᵀ``, the gradients are folded (:func:`_fold`),
        and after the update each decoder's kernels are set to its
        encoder's ``cᵀ`` (:func:`_retie`), so what the update made of them
        is dropped.  The parameters keep every stage's leaves.
      maxdiff: the reference's 'm' kernel-diversity objective, ``g ←
        w0·g − w1·g_div`` on every stage ``train_pair`` keeps
        (:func:`_combine`, after the fold); the result's ``div`` holds the
        ``w1·g_div`` it took off.

    With ``sym`` or ``maxdiff``, ``stage_conv`` and ``axis_name`` raise
    ValueError.  With both off the step is the untied reconstruction step.

    The loss returned is that of the parameters going *into* the step.
    The step is the span ``train_step`` (:func:`profiling.step
    <spectralae_torch.core.profiling.step>`), its optimizer ``update``.
    """
    if (sym or maxdiff) and (stage_conv is not None
                             or axis_name is not None):
        raise ValueError("sym and maxdiff train one device's whole net: "
                         "the model axis (stage_conv) and the data axis "
                         "(axis_name) of a tied or diverse net are not "
                         "supported")
    loss_kw = dict(domain=domain, tap_mode=tap_mode,
                   scale_by_dm=scale_by_dm, act=act,
                   compute_dtype=compute_dtype, remat=remat,
                   stage_conv=stage_conv, sym=sym)
    div = None
    with profiling.step(x):
        loss, grads = _grads(params, x, scales, accum_steps, train_pair,
                             loss_kw)
        if axis_name is not None:
            from ..dist import collectives
            loss, *leaves = collectives.pmean([loss, *grads.leaves()],
                                              axis_name)
            grads = AEParams.from_leaves(leaves)
        if sym:
            grads = _fold(grads)
        if maxdiff:
            grads, div = _combine(params, grads, train_pair, sym, w0, w1)
        with profiling.span("update"), torch.no_grad():
            new_params, new_mom, new_pg = tree_update(
                params, grads, opt.mom, opt.prev_grad, lr, alpha,
                active=active)
            if sym:
                new_params = _retie(new_params)
    return TrainStepResult(params=new_params,
                           opt=OptState(mom=new_mom, prev_grad=new_pg),
                           loss=loss, div=div)


# ------------------------------------------------ torch.optim optimizers

def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule``: ``init`` → ``end`` over ``steps``."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule``: ``init`` → ``alpha·init``."""
    def schedule(count: int) -> float:
        count = min(count, steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / steps))
        return init * ((1 - alpha) * decay + alpha)
    return schedule


def _join(first: Callable[[int], float], then: Callable[[int], float],
          boundary: int) -> Callable[[int], float]:
    """optax ``join_schedules`` of two schedules."""
    return lambda count: (first(count) if count < boundary
                          else then(count - boundary))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A ``torch.optim`` optimizer run functionally, as optax runs one.

    The state is ``{"count": updates so far, "optim": the torch optimizer's
    state_dict}``.  :meth:`update` builds the optimizer over copies of the
    parameters, loads a deep copy of the state, sets the learning rate to
    ``schedule(count)`` (optax's convention: the first update uses
    ``schedule(0)``), steps, and returns the new parameters and state — the
    arguments are left as they were.
    """

    name: str
    cls: type
    kwargs: dict
    schedule: Callable[[int], float]

    def _build(self, leaves, lr: float) -> torch.optim.Optimizer:
        return self.cls(leaves, lr=lr, **self.kwargs)

    def init(self, params: AEParams) -> dict:
        leaves = [t.detach().clone() for t in params.leaves()]
        return {"count": 0,
                "optim": self._build(leaves, self.schedule(0)).state_dict()}

    def update(self, params: AEParams, grads: AEParams,
               state: dict) -> tuple[AEParams, dict]:
        leaves = [t.detach().clone() for t in params.leaves()]
        count = int(state["count"])
        opt = self._build(leaves, self.schedule(count))
        opt.load_state_dict(copy.deepcopy(state["optim"]))
        for group in opt.param_groups:
            group["lr"] = self.schedule(count)
        for w, g in zip(leaves, grads.leaves()):
            w.grad = g
        opt.step()
        for w in leaves:
            w.grad = None
        return (AEParams.from_leaves(leaves),
                {"count": count + 1, "optim": opt.state_dict()})


def make_optimizer(name: str, lr: float, *, schedule: str = "constant",
                   warmup_steps: int = 0, total_steps: int = 0,
                   end_lr_frac: float = 0.0) -> Optimizer:
    """Named optimizers for the CLI (``--optimizer``), the ``torch.optim``
    counterparts of the JAX package's optax ones: ``adam``, ``adamw``
    (optax's weight decay of 1e-4, not torch's default 1e-2) and ``sgd``
    with momentum 0.9.

    ``schedule``: 'constant', 'cosine' (cosine decay to
    ``end_lr_frac·lr`` over ``total_steps``), or 'linear'; any schedule
    composes with ``warmup_steps`` of linear warmup from 0.
    """
    if schedule == "constant":
        sched = (_linear(0.0, lr, warmup_steps) if warmup_steps
                 else (lambda count: lr))
    elif schedule in ("cosine", "linear"):
        if total_steps <= 0:
            raise ValueError(f"schedule={schedule!r} needs total_steps>0 "
                             "(the CLI passes --steps)")
        decay = max(1, total_steps - warmup_steps)
        body = (_cosine(lr, decay, end_lr_frac) if schedule == "cosine"
                else _linear(lr, lr * end_lr_frac, decay))
        sched = (_join(_linear(0.0, lr, warmup_steps), body, warmup_steps)
                 if warmup_steps else body)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if name == "adam":
        return Optimizer(name, torch.optim.Adam,
                         dict(betas=(0.9, 0.999), eps=1e-8), sched)
    if name == "adamw":
        return Optimizer(name, torch.optim.AdamW,
                         dict(betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4), sched)
    if name == "sgd":
        return Optimizer(name, torch.optim.SGD, dict(momentum=0.9), sched)
    raise ValueError(f"unknown optimizer {name!r} "
                     "(choose adam, adamw, or sgd)")


def make_optim_train_step(optimizer: Optimizer, *, domain: str = "fft",
                          tap_mode: str = "centered",
                          scale_by_dm: bool = True, train_pair: int = -1,
                          act=None, compute_dtype=None,
                          remat: bool = False, accum_steps: int = 1,
                          sym: bool = False, maxdiff: bool = False,
                          w0: float = 1.0, w1: float = 10.0):
    """A train step around an :class:`Optimizer` — the counterpart of the
    JAX package's ``make_optax_train_step``.

    ``sym`` and ``maxdiff`` as in :func:`train_step`: the fold, then the
    combination, then the optimizer's update, then each decoder's kernels
    set to its encoder's ``cᵀ``.

    Returns ``step(params, opt_state, x, scales) -> TrainStepResult``;
    initialize ``opt_state = optimizer.init(params)``.
    """
    loss_kw = dict(domain=domain, tap_mode=tap_mode,
                   scale_by_dm=scale_by_dm, act=act,
                   compute_dtype=compute_dtype, remat=remat, sym=sym)

    def step(params, opt_state, x, scales) -> TrainStepResult:
        div = None
        with profiling.step(x):
            loss, grads = _grads(params, x, scales, accum_steps, train_pair,
                                 loss_kw)
            if sym:
                grads = _fold(grads)
            if maxdiff:
                grads, div = _combine(params, grads, train_pair, sym, w0,
                                      w1)
            with profiling.span("update"):
                new_params, new_state = optimizer.update(params, grads,
                                                         opt_state)
                if sym:
                    new_params = _retie(new_params)
        return TrainStepResult(params=new_params, opt=new_state, loss=loss,
                               div=div)

    return step
