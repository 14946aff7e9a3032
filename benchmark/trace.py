"""Reduce a ``torch.profiler`` trace of a traced slice to what the per-layer
metrics read.

The slice runs inside the host span ``bench.window``; the harness's own
spans around the calls into the program (``step_enqueue``, ``loss_read``,
``ring_index``) label the device's idle gaps by what the host was doing.
Device activity is every kernel, copy and fill on the card's timeline.
"""

from __future__ import annotations

import json
from pathlib import Path

WINDOW = "bench.window"
SPANS = ("step_enqueue", "loss_read", "ring_index")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    """Merged, sorted ``[(start, end)]`` of possibly overlapping ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list[dict], steps: int) -> dict | None:
    """``events``: a Chrome trace's ``traceEvents`` (times in µs).

    Returns ``window_s`` (the slice's host span), ``busy_s`` (the union of
    device activity inside it), ``steps``, ``kernels`` (device seconds by
    name) and ``gaps`` (the ten longest idle stretches, each with the host
    span that covered most of it); None when the trace holds no window."""
    win = [e for e in events
           if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    kernels: dict[str, float] = {}
    spans, device = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b))
                kernels[e["name"]] = kernels.get(e["name"], 0.0) \
                    + (b - a) * 1e-6
        elif cat == "user_annotation" and e.get("name") in SPANS:
            spans.append((a, b, e["name"]))
    busy = _union(device)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:10]:
        best, name = 0.0, "other"
        for s0, s1, span in spans:
            cover = min(b, s1) - max(a, s0)
            if cover > best:
                best, name = cover, span
        labelled.append([name, (b - a) * 1e-6])
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "steps": steps, "kernels": kernels, "gaps": labelled}


def load(path: str | Path) -> list[dict]:
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def breakdown(reduced: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten longest idle gaps, in seconds."""
    ops = sorted(reduced["kernels"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:200], s] for name, s in ops],
            "idle_gaps": reduced["gaps"]}


def kernel_seconds(reduced: dict, match) -> float:
    """Device seconds of the kernels whose name ``match`` accepts."""
    return sum(s for name, s in reduced["kernels"].items() if match(name))
