"""The kernel-diversity objective against its roofline: its least time on
the card over the device time of what the host launched inside the
program's ``diversity`` spans, a step, from the traced slice
(:mod:`benchmark.metrics.diversity_ms_per_step`).

The work is counted from the configuration's shapes, whichever form
computes it: a stage of N = A·B kernels of T taps has P = A·B·(A−1)·(B−1)
ordered pairs whose two indices both differ, each 5·T operations in the
direct difference form (difference, square, sum, scale, accumulate), at
the float32 rate outside the tensor cores; each kernel is read once and
each gradient written once, 8·N·T bytes.  With ``sym`` a pair's decoder
takes its encoder's term, so a pair is counted once.  The biases' terms
are left out."""

from benchmark import costs
from benchmark.metrics import diversity_ms_per_step


def bound_ms(cfg: dict, nx: int, ny: int) -> float:
    sts = costs.stages(cfg, nx, ny)
    if cfg["sym"]:
        sts = sts[:len(sts) // 2]
    total = 0.0
    for st in sts:
        n, t = st.m * st.d, st.nk * st.nl
        pairs = n * (st.m - 1) * (st.d - 1)
        total += costs.bound_ms(5.0 * t * pairs, 8.0 * n * t)[0]
    return total


def read(run: dict) -> float | None:
    cfg, t = run["cell"]["config"], run["cell"]["traffic"]
    if not cfg.get("maxdiff"):
        return None
    ms = diversity_ms_per_step.device_ms(run)
    if not ms:
        return None
    return 100.0 * bound_ms(cfg, t["nx"], t["ny"]) / ms
