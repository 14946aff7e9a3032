"""The step's spectral contractions against their roofline: their least
time on the card (:func:`benchmark.costs.spectral_conv_bound_ms`, counted
from shapes whichever kernel runs them) over the device time of the kernels
named here, a step, from the traced slice."""

import re

from benchmark import costs
from benchmark import trace as tracing

NAMES = re.compile(r"cmul_contract_kernel")


def read(run: dict) -> float | None:
    tr = run["trace"]
    t = run["cell"]["traffic"]
    if tr is None or t["domain"] != "fft":
        return None
    s = tracing.kernel_seconds(tr, NAMES.search)
    if s <= 0:
        return None
    bound = costs.spectral_conv_bound_ms(run["cell"]["config"], t["batch"],
                                         t["nx"], t["ny"])
    return 100.0 * bound / (1e3 * s / tr["steps"])
