"""How much work the card had queued when the host opened a step: the
median over the traced slice's steps of the program's ``train_step`` span's
device begin minus its host begin, in ms.  Near 0 the card waits on the
host; large, the host runs ahead and the launch queue paces it."""

from benchmark import program_trace


def read(run: dict) -> float | None:
    return program_trace.queued_ms(run)
