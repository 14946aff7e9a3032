"""Tracing / profiling / metrics (SURVEY.md §5.1, §5.5).

Port of :mod:`spectralae.core.profiling`, less its ``StepTimer``, which no
entry point of the port uses.  The reference has only commented-out chrono
timers and ``cout`` MSE prints.  Here: a ``torch.profiler`` trace context
for device-level traces and a structured metrics logger (stdout + JSONL),
used by the CLI train loop.
"""

from __future__ import annotations

import contextlib
import json
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
