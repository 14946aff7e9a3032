"""Set-up: from the harness's first line to the window's start (imports,
the program's kernel library, weights and frames made from the seed, the
checked first steps and the warm-up steps; host clock)."""


def read(run: dict) -> float:
    return run["setup_s"]
