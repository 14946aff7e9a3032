"""Entry ``step_tied``: batched training of the tied, kernel-diverse net.

:mod:`benchmark.entries.step`'s loop, window and traced slice, with the
configuration's ``sym``, ``maxdiff``, ``w0`` and ``w1`` passed to
:func:`spectralae_torch.train.modern.train_step`.  Set-up's checked steps
keep, beside what :func:`benchmark.entries.step.check_steps` keeps, the
``w1·g_div`` each step returned (its ``div``).  After the window the plain
reference (:mod:`benchmark.reference.tied`) follows those steps from the
program's weights, and the numbers are :mod:`benchmark.compare`'s three
and two more:

- ``div_gap``: the worst leaf's (a stage's kernels or its biases) gap,
  over the checked steps, between the ``w1·g_div`` the step returned and
  the float64 reference's: the norm of the difference over the
  reference's norm.  The reconstruction gradients run to millions and
  ``w1·g_div`` to tens, so without the diversity term the other gaps
  move by about 1e-5; this one sees it;
- ``tie_gap``: the largest ``|f − cᵀ|`` over the pairs of the weights after
  each checked step, which the re-tie makes 0.

The traced slice is :func:`benchmark.entries.step.traced`'s, and its
reduction keeps one thing more, ``launched_s``: for each span in
:data:`LAUNCHED`, the device seconds of the kernels, copies and fills
whose launch the host made inside that span, matched through the trace's
correlation ids.  Where the host paces the card, a span's device begin to
end holds the card's waits for the launches; this time does not.

A program whose ``train_step`` takes no ``sym`` stops at its first step
with a TypeError, and the run gives no result.
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

from benchmark import compare
from benchmark import trace as tracing
from benchmark.entries import step
from benchmark.reference import tied as reference

#: the program's spans whose launched device work the traced slice keeps
LAUNCHED = ("diversity",)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Loop(step.Loop):
    """:class:`benchmark.entries.step.Loop` with the configuration's
    objectives on the step."""

    def __init__(self, cell: dict, inputs: step.Inputs, slots: int,
                 compute_dtype=None):
        super().__init__(cell, inputs, slots, compute_dtype)
        cfg = cell["config"]
        self.step_fn = functools.partial(
            self.step_fn, sym=cfg["sym"], maxdiff=cfg["maxdiff"],
            w0=cfg["w0"], w1=cfg["w1"])


def check_steps(loop: Loop, leaves: list, n: int) -> dict:
    """The first ``n`` steps of ``loop``: what
    :func:`benchmark.entries.step.check_steps` keeps, and ``div``, each
    step's ``w1·g_div`` leaves (None where the step returned none)."""
    params = [[t.clone() for t in leaves]]
    losses, grad1, div = [], None, []
    for _ in range(n):
        r = loop.one()
        if grad1 is None:
            grad1 = [t.detach().clone() for t in r.opt.prev_grad.leaves()]
        params.append([t.detach().clone() for t in loop.params.leaves()])
        losses.append(r.loss)
        div.append(None if r.div is None
                   else [t.detach().clone() for t in r.div.leaves()])
    return {"losses": [float(v) for v in losses], "grad1": grad1,
            "params": params, "div": div}


def div_gap(got: list, want: list) -> float:
    """The worst leaf's ``‖got − want‖ / ‖want‖`` over the steps; inf
    where a step has no diversity term on either side."""
    if len(got) != len(want):
        return math.inf
    gaps = []
    for g, w in zip(got, want):
        if g is None or w is None or len(g) != len(w):
            return math.inf
        for a, b in zip(g, w):
            b = b.detach().double()
            ref = float(torch.linalg.vector_norm(b))
            diff = float(torch.linalg.vector_norm(a.detach().double() - b))
            gaps.append(diff / ref if ref > 0 else diff)
    return max(gaps) if gaps and all(map(math.isfinite, gaps)) \
        else math.inf


def tie_gap(states: list) -> float:
    """The largest ``|f − cᵀ|`` over the pairs of each of ``states``."""
    gaps = [0.0]
    for w in states:
        n = len(w) // 2
        for p in range(n // 2):
            f, c = w[2 * (n - 1 - p)], w[2 * p]
            gaps.append(float((f - c.transpose(0, 1)).abs().max()))
    return max(gaps)


def launched_s(events: list[dict], names) -> dict[str, float]:
    """``events``: a Chrome trace's ``traceEvents`` (times in µs).  For
    each of ``names``, the device seconds (the union of their intervals)
    of the device events whose launch on the host falls inside a host span
    of that name.  The step runs the objective on one host thread after
    its backward has returned, so no other thread launches meanwhile."""
    spans = {n: [] for n in names}
    launches, device = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat == "user_annotation" and e.get("name") in spans:
            spans[e["name"]].append((a, b))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches.append((a, args["correlation"]))
        elif cat in tracing.DEVICE_CATS and "correlation" in args:
            device.setdefault(args["correlation"], []).append((a, b))
    out = {}
    for name, ivs in spans.items():
        ivs = tracing._union(ivs)
        inside = []
        for t, corr in launches:
            if any(a <= t <= b for a, b in ivs):
                inside.extend(device.get(corr, ()))
        out[name] = sum(b - a for a, b in tracing._union(inside)) * 1e-6
    return out


def traced(loop: Loop, steps: int, device) -> dict | None:
    """:func:`benchmark.entries.step.traced`'s slice and reduction, with
    ``launched_s`` (:func:`launched_s` over :data:`LAUNCHED`) beside."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(tracing.WINDOW):
            for _ in range(steps):
                loop.one()
            step._sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = tracing.load(path)
    finally:
        os.unlink(path)
    reduced = tracing.reduce(events, steps)
    if reduced is not None:
        reduced["launched_s"] = launched_s(events, LAUNCHED)
    return reduced


def reference_readings(cell: dict, inputs: step.Inputs, prog: dict,
                       n: int) -> dict:
    """The tied reference over the same first ``n`` batches, each step
    from the weights the program gave it, and the five numbers."""
    batches = [inputs.pattern.batch_at(k) for k in range(n)]
    ref = reference.follow(prog["params"][:n], batches, cell["config"],
                           cell["traffic"]["domain"],
                           rows=cell["traffic"]["reference_rows"])
    out = compare.readings(prog, ref)
    if cell["config"]["maxdiff"]:
        out["div_gap"] = div_gap(prog["div"], ref["div"])
    if cell["config"]["sym"]:
        out["tie_gap"] = tie_gap(prog["params"][1:])
    return out


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    traffic = cell["traffic"]
    n = traffic["check_steps"]
    inputs = step.Inputs(cell, seed, device)
    loop = Loop(cell, inputs, traffic["ring"])
    prog = check_steps(loop, inputs.leaves, n)
    for _ in range(traffic["warmup_steps"]):
        loop.one()
    step._sync(device)
    setup_s = time.perf_counter() - t0
    win = step.window(loop, seconds, device)
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
