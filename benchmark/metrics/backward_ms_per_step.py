"""Device milliseconds a step of the program's ``backward`` span (around
``torch.autograd.grad``): cuDNN's weight and data gradients, K1's and K2's
gradients and the pooling gathers' gradients, over the traced slice's
steps."""

from benchmark import program_trace


def read(run: dict) -> float | None:
    return program_trace.device_ms_per_step(run, ("backward",))
