"""Device milliseconds a step of cuFFT's kernels (the frames' transforms,
the reconstruction's and its gradient's), from the traced slice."""

import re

from benchmark import trace as tracing

NAMES = re.compile(r"fft|radix", re.IGNORECASE)


def read(run: dict) -> float | None:
    tr = run["trace"]
    if tr is None or run["cell"]["traffic"]["domain"] != "fft":
        return None
    s = tracing.kernel_seconds(tr, NAMES.search)
    return 1e3 * s / tr["steps"] if s > 0 else None
