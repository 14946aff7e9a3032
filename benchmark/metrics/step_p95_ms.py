"""The 95th percentile of the step's time on the card: the gap between
consecutive CUDA events that the harness records in the step's stream after
each step of the window, over every step (a stall's gap included); the
nearest-rank percentile."""

import math


def read(run: dict) -> float:
    ms = sorted(run["window"]["step_ms"])
    return ms[math.ceil(0.95 * len(ms)) - 1]
