"""Tracing / profiling / metrics (SURVEY.md §5.1, §5.5).

Port of :mod:`spectralae.core.profiling`.  The reference has only
commented-out chrono timers and ``cout`` MSE prints.  Here: a
``torch.profiler`` trace context for device-level traces
(:func:`device_trace`), the recorder of the train step's spans and
counters, and a structured metrics logger (stdout + JSONL), used by the CLI
train loop.

**The recorder.**  :func:`span` marks a layer of the train step,
:func:`grad_span` the backward of a region whose backward is autograd's
own, :func:`count` counts at a boundary, and :func:`step` opens each train
step.  The recorder is on between :func:`enable` and :func:`disable`, and
on its own while a ``torch.profiler`` session records: :func:`step` tests
``torch.autograd.profiler._is_profiler_enabled`` once at the top of each
train step, and a new session starts a fresh store.  Off, every call tests
the one flag :data:`recording` and does nothing more: no
``record_function``, no autograd hook, no CUDA event.

On, a span enters ``torch.profiler.record_function`` (so it sits on the
trace's timeline) and keeps a record: its name, the index of the span open
around it on its thread, the ordinal of the train step it belongs to, the
thread, host begin and end by ``time.time_ns()`` and, once a step has run
on a CUDA tensor, a begin and an end CUDA event (from a pool reused by
every session) recorded on the current stream.  The host times are on the
exported trace's clock (``baseTimeNanoseconds`` + ``ts`` × 1000, epoch
nanoseconds).  As the recorder meets its CUDA device it synchronises once
and records an anchor event at a known host time; :func:`snapshot`
synchronises again and places every event on the host clock through it.  A
span's device begin is then when the card reached that point of its
stream, and its device begin minus its host begin the work the card still
had queued when the host opened it.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import IO

import torch


@contextlib.contextmanager
def device_trace(logdir: str | Path):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card, with the recorder on: written to ``logdir/trace.json``
    (Chrome trace format, for chrome://tracing or Perfetto) and the
    recorder's :func:`snapshot` to ``logdir/spans.json`` when the block
    ends."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(str(logdir / "trace.json"))
        dump(logdir / "spans.json")
    finally:
        disable()


#: whether the recorder is on: the one test every span and count makes
recording = False
_auto = False           # on because a profiler session records
_store: _Store | None = None
_lock = threading.Lock()
_local = threading.local()
_events: list = []      # CUDA events, reused by every session
_streams: dict = {}     # (stream id, device, type) -> its Stream
_NULL = contextlib.nullcontext()


class _Span:
    """One span's record while it is kept."""

    __slots__ = ("name", "index", "parent", "step", "thread", "host_begin",
                 "host_end", "begin", "end", "rf")

    def __init__(self, name, index, parent, step, thread):
        self.name, self.index, self.parent, self.step = (name, index,
                                                          parent, step)
        self.thread = thread
        self.host_end = self.begin = self.end = self.rf = None


class _Store:
    """One session's spans and counters."""

    def __init__(self):
        self.spans: list[_Span] = []
        self.counters: dict[str, int] = {}
        self.device: torch.device | None = None
        self.anchor = None      # (CUDA event, host ns) once on a device
        self.step = None        # ordinal of the train step now open
        self.steps = 0          # train steps begun
        self.n_events = 0       # events of the pool this session holds

    def event(self):
        """The pool's next event, recorded on the current stream."""
        with _lock:
            i = self.n_events
            self.n_events += 1
            if i == len(_events):
                _events.append(torch.cuda.Event(enable_timing=True))
            ev = _events[i]
        ev.record(_current_stream(self.device))
        return ev

    def meet(self, device: torch.device) -> None:
        """Anchor the session's events on ``device``: with the card's queue
        drained, the host clock read and an event recorded at once.  The
        event and its stream are made, and recorded once, beforehand: an
        event's first record creates it, which took ~20 µs on an H100, and
        the anchor read that much off."""
        torch.cuda.synchronize(device)
        self.device = device
        ev = self.event()
        stream = _current_stream(device)
        torch.cuda.synchronize(device)
        host = time.time_ns()
        ev.record(stream)
        self.anchor = (ev, host)


def _start(auto: bool) -> None:
    global _store, recording, _auto
    _store = _Store()
    _auto = auto
    recording = True


def enable() -> None:
    """Turn the recorder on with a fresh store.  Its spans record CUDA
    events from the first train step on a CUDA input onward."""
    _start(False)


def disable() -> None:
    """Turn the recorder off; its store stays for :func:`snapshot`."""
    global recording, _auto
    recording = _auto = False


def _current_stream(device: torch.device):
    """``torch.cuda.current_stream(device)``, without building a new
    ``Stream`` object on every call: one is kept for each stream met."""
    sid = torch._C._cuda_getCurrentStream(device.index)
    stream = _streams.get(sid)
    if stream is None:
        stream = _streams[sid] = torch.cuda.Stream(
            stream_id=sid[0], device_index=sid[1], device_type=sid[2])
    return stream


def _stack(store: _Store) -> tuple[list[int], int]:
    """The indices of the spans open on this thread, and its id."""
    st = getattr(_local, "stack", None)
    if st is None or st[0] is not store:
        st = _local.stack = (store, [], threading.get_native_id())
    return st[1], st[2]


def _open(name: str) -> tuple[_Store, _Span]:
    store = _store
    stack, thread = _stack(store)
    with _lock:
        rec = _Span(name, len(store.spans), stack[-1] if stack else None,
                    store.step, thread)
        store.spans.append(rec)
    stack.append(rec.index)
    rec.host_begin = time.time_ns()
    rec.rf = torch.profiler.record_function(name)
    rec.rf.__enter__()
    if store.device is not None:
        rec.begin = store.event()
    return store, rec


def _close(opened: tuple[_Store, _Span]) -> None:
    store, rec = opened
    if rec.begin is not None:
        rec.end = store.event()
    rec.rf.__exit__(None, None, None)
    rec.host_end = time.time_ns()
    rec.rf = None
    stack = _stack(store)[0]
    if rec.index in stack:
        stack.remove(rec.index)


class _Open:
    __slots__ = ("name", "opened")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.opened = _open(self.name)

    def __exit__(self, *exc):
        _close(self.opened)


def span(name: str):
    """A context that records span ``name`` while the recorder is on."""
    if not recording:
        return _NULL
    return _Open(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while the recorder is on."""
    if not recording:
        return
    store = _store
    with _lock:
        store.counters[name] = store.counters.get(name, 0) + n


class _Step(_Open):
    __slots__ = ("x",)

    def __init__(self, x):
        super().__init__("train_step")
        self.x = x

    def __enter__(self):
        store = _store
        if store.device is None and self.x.is_cuda:
            store.meet(self.x.device)
        store.step = store.steps
        store.steps += 1
        super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.opened[0].step = None


def step(x: torch.Tensor):
    """The context of one train step on input ``x``: the ``train_step``
    span, whose ordinal every span opened inside it shares.  It first
    follows the profiler: a session that has begun recording turns the
    recorder on with a fresh store, and once the session has ended, the
    recorder it turned on goes off."""
    profiler = torch.autograd.profiler._is_profiler_enabled
    if profiler and not recording:
        _start(True)
    elif _auto and not profiler:
        disable()
    if not recording:
        return _NULL
    return _Step(x)


def grad_span(name: str, out: torch.Tensor, *inputs) -> torch.Tensor:
    """Record span ``name`` over the backward of the region that made
    ``out`` from ``inputs`` (the tensors it read that may carry a
    gradient), while the recorder is on; returns ``out``.

    The region is the autograd graph from ``out``'s node back to the
    nodes of ``inputs`` and of leaves.  A pre-hook on ``out``'s node opens
    the span on the thread that runs the backward, and a hook on each of
    the region's nodes counts it done: the last one closes it."""
    if recording and out.grad_fn is not None:
        _watch(name, out.grad_fn, inputs)
    return out


def _watch(name: str, root, inputs) -> None:
    stop = {t.grad_fn for t in inputs
            if t is not None and t.grad_fn is not None}
    region, todo = [], [root]
    seen = {root}
    while todo:
        node = todo.pop()
        region.append(node)
        for nxt, _ in node.next_functions:
            if (nxt is None or nxt in seen or nxt in stop
                    or type(nxt).__name__ == "AccumulateGrad"):
                continue
            seen.add(nxt)
            todo.append(nxt)
    state = {"opened": None, "left": len(region)}

    def pre(grad_outputs):
        if recording and state["opened"] is None:
            state["opened"] = _open(name)

    def post(grad_inputs, grad_outputs):
        state["left"] -= 1
        if state["left"] == 0 and state["opened"] is not None:
            _close(state["opened"])

    root.register_prehook(pre)
    for node in region:
        node.register_hook(post)


def snapshot() -> dict | None:
    """The store as plain data, or None where the recorder never ran.

    Synchronises the card, and places each span's events on the host
    clock: ``spans`` (each ``name``, ``parent`` (an index into ``spans``
    or None), ``step`` (the train step's ordinal or None), ``thread``,
    ``host_begin_ns``, ``host_end_ns``, ``device_begin_ns`` and
    ``device_end_ns``, None where not recorded), ``counters``, ``steps``
    (train steps begun) and ``anchor`` (the device and the anchor's host
    ns).  A recorder that a profiler session turned on, whose session has
    ended, goes off here."""
    if _auto and not torch.autograd.profiler._is_profiler_enabled:
        disable()
    store = _store
    if store is None:
        return None
    anchor = anchor_ns = None
    if store.anchor is not None:
        torch.cuda.synchronize(store.device)
        anchor, anchor_ns = store.anchor

    def on_host(ev):
        if ev is None:
            return None
        return anchor_ns + round(anchor.elapsed_time(ev) * 1e6)

    spans = [{"name": r.name, "parent": r.parent, "step": r.step,
              "thread": r.thread, "host_begin_ns": r.host_begin,
              "host_end_ns": r.host_end,
              "device_begin_ns": on_host(r.begin),
              "device_end_ns": on_host(r.end)}
             for r in list(store.spans)]
    with _lock:
        counters = dict(store.counters)
    return {"spans": spans, "counters": counters, "steps": store.steps,
            "anchor": {"device": None if store.device is None
                       else str(store.device), "host_ns": anchor_ns}}


def dump(path: str | Path) -> None:
    """Write :func:`snapshot` to ``path`` as JSON."""
    Path(path).write_text(json.dumps(snapshot()))


class MetricsLogger:
    """Structured metrics: one JSON object per record, stdout and/or JSONL.

    Replaces the reference's cout-only telemetry (SURVEY.md §5.5)."""

    def __init__(self, path: str | Path | None = None, *, echo: bool = True):
        self._fh: IO | None = open(path, "a") if path else None
        self._echo = echo

    def log(self, **record):
        line = json.dumps(record)
        if self._echo:
            print(line, flush=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
