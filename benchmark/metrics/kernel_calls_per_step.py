"""Calls a step of the hand-written kernels' wrappers (K1 in the fft
domain, K2 where a coordinate stage has M·D ≤ 64), from the program's
``kernel.<wrapper>`` counters over the traced slice's steps."""

from benchmark import program_trace


def read(run: dict) -> float | None:
    return program_trace.counted_per_step(run, "kernel.")
