"""Entry ``step``: batched training through the port's train step.

The call ``train --mode step`` makes (``spectralae_torch/cli/main.py``
``_train_steps``): :func:`spectralae_torch.train.modern.train_step` with
the reference optimizer, each step on the next batch of a ring of frames
held on the card, the loss of every ``log_every``-th step kept and read
when the next is kept, one interval late, so that no read drains the
card's queue (the CLI reads it at once, and the first steps after each
read then wait on the host).

Set-up builds the weights and the ring from the seed on the device, drives
the one training state through its first ``check_steps`` steps and
``warmup_steps`` more, all through the window's own loop, and hands that
state to the window.  The window runs ``seconds`` of steps; a CUDA event
recorded after each step in its stream times the steps on the card.  With
``trace`` a slice of ``trace_steps`` more steps runs under the profiler.
Once the window has closed and the program's state is freed, the plain
reference follows the first steps on the same frames, the first from the
seed's weights and each later one from the weights the program gave it
(:mod:`benchmark.compare`).
"""

from __future__ import annotations

import functools
import gc
import math
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import compare, costs, frames
from benchmark import trace as tracing
from benchmark.reference import autoencoder as reference


class HostEvent:
    """A CPU run's stand-in for a CUDA event: the host clock at record."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _event(device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return HostEvent()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_leaves(cfg: dict, gen: torch.Generator, device) -> list:
    """The weights (``c``, ``b`` of each stage), uniform in ±rmax, drawn in
    one call on the device."""
    shapes = []
    for st in costs.stages(cfg, 1 << 10, 1 << 10):
        shapes += [(st.m, st.d, st.nk, st.nl), (st.m,)]
    sizes = [math.prod(s) for s in shapes]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    flat = (2.0 * u - 1.0) * cfg["rmax"]
    return [p.reshape(s).clone() for p, s in zip(flat.split(sizes), shapes)]


class Inputs:
    """What the seed makes: the weights and the clip's pattern."""

    def __init__(self, cell: dict, seed: int, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed & ((1 << 64) - 1))
        self.leaves = make_leaves(cell["config"], gen, device)
        self.pattern = frames.Pattern(cell["traffic"], gen, device)


class Loop:
    """The window's call and feed: one step of the program on the ring's
    next batch, every ``log_every``-th step's loss read one interval
    late.

    As the CLI does (``cli/main.py`` ``_device``), cuBLAS and cuDNN run
    TF32 only where the configuration says ``tf32``.  ``compute_dtype`` is
    the program's reduced-precision option (``--bf16``), for the control
    alone."""

    def __init__(self, cell: dict, inputs: Inputs, slots: int,
                 compute_dtype=None):
        from spectralae_torch.core.types import AEParams, init_opt_state
        from spectralae_torch.train import modern
        cfg, traffic = cell["config"], cell["traffic"]
        torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
        torch.backends.cudnn.allow_tf32 = cfg["tf32"]
        s, pairs = cfg["scale"], cfg["pairs"]
        self.step_fn = functools.partial(
            modern.train_step, scales=(s,) * pairs + (-s,) * pairs,
            lr=cfg["lr"], alpha=cfg["alpha"], domain=traffic["domain"],
            tap_mode=cfg["tap_mode"], scale_by_dm=cfg["scale_by_dm"],
            active=cfg["active_lr"], compute_dtype=compute_dtype)
        self.params = AEParams.from_leaves(
            [t.clone() for t in inputs.leaves])
        self.opt = init_opt_state(self.params)
        self.ring = frames.ring(inputs.pattern, slots)
        self.log_every = traffic["log_every"]
        self.i = 0
        self.enqueue_s: list[float] = []
        self.bad_losses = 0
        self.pending = None

    def one(self):
        i = self.i
        with record_function("ring_index"):
            x = self.ring[i % self.ring.shape[0]]
        t = time.perf_counter()
        with record_function("step_enqueue"):
            res = self.step_fn(self.params, self.opt, x)
        self.enqueue_s.append(time.perf_counter() - t)
        if i % self.log_every == 0:
            with record_function("loss_read"):
                self.flush()
            self.pending = res.loss
        self.params, self.opt = res.params, res.opt
        self.i += 1
        return res

    def flush(self):
        """Read the loss kept last, if any, and count it if it is not
        finite."""
        if self.pending is not None and not math.isfinite(
                float(self.pending)):
            self.bad_losses += 1
        self.pending = None


def check_steps(loop: Loop, leaves: list, n: int) -> dict:
    """The first ``n`` steps of ``loop``, as :func:`compare.readings`
    takes them: the losses, the first gradient from the optimizer's state
    after one step, and the weights each step received and those that step
    ``n + 1`` receives."""
    params = [[t.clone() for t in leaves]]
    losses, grad1 = [], None
    for _ in range(n):
        r = loop.one()
        if grad1 is None:
            grad1 = [t.detach().clone() for t in r.opt.prev_grad.leaves()]
        params.append([t.detach().clone() for t in loop.params.leaves()])
        losses.append(r.loss)
    return {"losses": [float(v) for v in losses], "grad1": grad1,
            "params": params}


def window(loop: Loop, seconds: float, device) -> dict:
    _sync(device)
    loop.flush()
    loop.enqueue_s.clear()
    loop.bad_losses = 0
    events = [_event(device)]
    t0 = time.perf_counter()
    events[0].record()
    while True:
        loop.one()
        events.append(_event(device))
        events[-1].record()
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    loop.flush()
    steps = len(events) - 1
    return {"steps": steps,
            "frames": steps * loop.ring.shape[1],
            "seconds": elapsed,
            "step_ms": [a.elapsed_time(b)
                        for a, b in zip(events[:-1], events[1:])],
            "enqueue_ms": [s * 1e3 for s in loop.enqueue_s],
            "failed": min(steps, loop.bad_losses * loop.log_every)}


def traced(loop: Loop, steps: int, device) -> dict | None:
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(tracing.WINDOW):
            for _ in range(steps):
                loop.one()
            _sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return tracing.reduce(tracing.load(path), steps)
    finally:
        os.unlink(path)


def reference_readings(cell: dict, inputs: Inputs, prog: dict,
                       n: int) -> dict:
    """The plain reference over the same first ``n`` batches, each step
    from the weights the program gave it, and the numbers of
    :mod:`benchmark.compare` for ``prog`` against it."""
    batches = [inputs.pattern.batch_at(k) for k in range(n)]
    ref = reference.follow(prog["params"][:n], batches, cell["config"],
                           cell["traffic"]["domain"],
                           rows=cell["traffic"]["reference_rows"])
    return compare.readings(prog, ref)


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    traffic = cell["traffic"]
    n = traffic["check_steps"]
    inputs = Inputs(cell, seed, device)
    loop = Loop(cell, inputs, traffic["ring"])
    prog = check_steps(loop, inputs.leaves, n)
    for _ in range(traffic["warmup_steps"]):
        loop.one()
    _sync(device)
    setup_s = time.perf_counter() - t0
    win = window(loop, seconds, device)
    reduced = traced(loop, traffic["trace_steps"], device) if trace else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = reference_readings(cell, inputs, prog, n)
    return {"cell": cell, "setup_s": setup_s, "window": win,
            "trace": reduced, "memory_peak_bytes": peak,
            "attempted": win["steps"], "failed": win["failed"],
            "numbers": numbers, "reference_s": time.perf_counter() - t}
