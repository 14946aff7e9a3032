"""Device milliseconds a step of the kernel-diversity objective: the
kernels, copies and fills that the host launched inside the program's
``diversity`` spans (each stage's repulsion of its kernels and of its
biases, ``losses.py`` ``stage_diversity``), matched to the card's timeline
through the trace's correlation ids, over the traced slice's steps.  Not
the spans' device begin to end, which holds the card's waits for the
launches where the host paces it (``benchmark/entries/step_tied.py``)."""


def device_ms(run: dict, name: str = "diversity") -> float | None:
    """Device ms a step of what the host launched inside the spans
    ``name``; None where the slice kept no such time."""
    tr = run.get("trace")
    if tr is None:
        return None
    s = (tr.get("launched_s") or {}).get(name)
    return 1e3 * s / tr["steps"] if s else None


def read(run: dict) -> float | None:
    return device_ms(run)
