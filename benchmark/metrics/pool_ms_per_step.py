"""Device milliseconds a step of the pooling, forward and backward: from
the card's begin to its end of every ``pool`` and ``pool.grad`` span of the
program (the spectral pooling's gathers and their ``index_add`` gradients;
the coordinate domain's max-pool, nearest upsample and their gradients),
over the traced slice's steps."""

from benchmark import program_trace


def read(run: dict) -> float | None:
    return program_trace.device_ms_per_step(run, ("pool", "pool.grad"))
