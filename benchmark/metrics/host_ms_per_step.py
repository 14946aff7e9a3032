"""The host's time to enqueue one step: the harness's clock around each
call of the program's train step, with no synchronise, as a mean over the
window (untraced, so the profiler adds nothing to it).  Where the launch
queue is full the call waits for the card, and this reads the card's pace."""

import statistics


def read(run: dict) -> float:
    return statistics.fmean(run["window"]["enqueue_ms"])
