"""Kernel spectra a step that a tied decoder stage read from its encoder
instead of computing its own: the program's ``kernel_spectra.shared``
counter (``model/autoencoder.py`` ``forward_fft`` with ``sym``) over the
traced slice's steps; one a stage pair.  None where the program keeps no
such counter."""

from benchmark import program_trace

NAME = "kernel_spectra.shared"


def read(run: dict) -> float | None:
    snap = program_trace.snapshot() if run.get("trace") else None
    if snap is None or NAME not in snap["counters"]:
        return None
    return program_trace.counted_per_step(run, NAME)
