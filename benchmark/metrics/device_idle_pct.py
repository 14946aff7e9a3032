"""The card's idle share of the traced slice: 100 minus the union of its
kernels, copies and fills, over the slice's length."""


def read(run: dict) -> float | None:
    tr = run["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
