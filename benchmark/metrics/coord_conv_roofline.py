"""The step's valid correlations against their roofline: their least time
on the card (:func:`benchmark.costs.coord_conv_bound_ms`, counted from
shapes) over the device time of every conv kernel, cuDNN's and the port's
own (K2), a step, from the traced slice.

cuDNN's engines include its FFT convolutions: their tile transforms
(``fft2d_*``, ``DSE::*``, ``region_transform*``) and the complex products
they hand to cuBLAS (``*gemm_cf32cf32*``); nothing else in a coordinate
step transforms or multiplies complex planes."""

import re

from benchmark import costs
from benchmark import trace as tracing

NAMES = re.compile(r"conv_valid_kernel|cudnn|wgrad|dgrad|fprop|fft2d_|DSE::"
                   r"|region_transform|gemm_cf32cf32")


def read(run: dict) -> float | None:
    tr = run["trace"]
    t = run["cell"]["traffic"]
    if tr is None or t["domain"] != "coord":
        return None
    s = tracing.kernel_seconds(tr, NAMES.search)
    if s <= 0:
        return None
    bound = costs.coord_conv_bound_ms(run["cell"]["config"], t["batch"],
                                      t["nx"], t["ny"])
    return 100.0 * bound / (1e3 * s / tr["steps"])
