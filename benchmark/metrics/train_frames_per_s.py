"""Frames trained per second: every frame the window's steps trained, over
the window's whole time, from the first step's launch to the synchronise
after the last step (host clock)."""


def read(run: dict) -> float:
    w = run["window"]
    return w["frames"] / w["seconds"]
