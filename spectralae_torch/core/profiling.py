"""Tracing / profiling / metrics (SURVEY.md §5.1, §5.5).

Port of :mod:`spectralae.core.profiling`.  The reference has only
commented-out chrono timers and ``cout`` MSE prints.  Here: a
``torch.profiler`` trace context for device-level traces, a per-step
wall-clock timer with rolling stats, and a structured metrics logger
(stdout + JSONL), used by the CLI train loop.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time
from collections import deque
from pathlib import Path
from typing import IO

import torch


@contextlib.contextmanager
def device_trace(logdir: str | Path):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card; written to ``logdir/trace.json`` (Chrome trace format,
    for chrome://tracing or Perfetto) when the block ends."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


class StepTimer:
    """Rolling per-step wall-clock stats (ms).

    ``device``: where the step's work runs.  On a CUDA device the timer
    synchronises with it when the step starts and when it ends, so a step
    is timed to the end of its device work, not to the end of its launches.
    """

    def __init__(self, window: int = 100, *,
                 device: torch.device | str | None = None):
        self._times: deque[float] = deque(maxlen=window)
        self._t0: float | None = None
        self._device = torch.device(device) if device is not None else None

    def _sync(self):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._times.append(time.perf_counter() - self._t0)

    @property
    def last_ms(self) -> float:
        return self._times[-1] * 1e3 if self._times else float("nan")

    @property
    def median_ms(self) -> float:
        return (statistics.median(self._times) * 1e3 if self._times
                else float("nan"))

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / statistics.median(self._times) if self._times else 0.0


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
