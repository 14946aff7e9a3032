"""The program's own spans and counters over a traced slice.

The port's recorder (``spectralae_torch.core.profiling``) turns itself on
while a ``torch.profiler`` session records a train step, so the slice that
:func:`benchmark.entries.step.traced` runs under the profiler fills it, and
the metrics read it in the same process once the slice has ended.  Each
span holds host and device begin and end in ns on one clock (the host's
``time.time_ns()``); the device times are when the card reached the span
in its stream.  A program without the recorder, or a run that was not
traced, gives None, and the metrics that read it are left out.
"""

from __future__ import annotations

import statistics


def snapshot() -> dict | None:
    """``spectralae_torch.core.profiling.snapshot()``, or None where the
    program has no recorder."""
    try:
        from spectralae_torch.core import profiling
        read = profiling.snapshot
    except (ImportError, AttributeError):
        return None
    return read()


def _steps(run: dict):
    """The snapshot and its ``train_step`` spans, or None where the run
    was not traced or the recorder saw no step."""
    if run.get("trace") is None:
        return None
    snap = snapshot()
    if snap is None:
        return None
    steps = [s for s in snap["spans"] if s["name"] == "train_step"]
    return (snap, steps) if steps else None


def device_ms_per_step(run: dict, names) -> float | None:
    """Device ms a step from device begin to device end of every span
    named in ``names``."""
    got = _steps(run)
    if got is None:
        return None
    snap, steps = got
    spans = [s for s in snap["spans"] if s["name"] in names
             and s["device_begin_ns"] is not None
             and s["device_end_ns"] is not None]
    if not spans:
        return None
    ns = sum(s["device_end_ns"] - s["device_begin_ns"] for s in spans)
    return ns * 1e-6 / len(steps)


def queued_ms(run: dict) -> float | None:
    """The median over the steps of the ``train_step`` span's device begin
    minus its host begin, in ms."""
    got = _steps(run)
    if got is None:
        return None
    waits = [(s["device_begin_ns"] - s["host_begin_ns"]) * 1e-6
             for s in got[1] if s["device_begin_ns"] is not None]
    return statistics.median(waits) if waits else None


def counted_per_step(run: dict, prefix: str) -> float | None:
    """The counters whose name starts with ``prefix``, summed, a step."""
    got = _steps(run)
    if got is None:
        return None
    snap, steps = got
    return sum(v for k, v in snap["counters"].items()
               if k.startswith(prefix)) / len(steps)
