"""The general harness: finds a cell's files by the names in
``BENCHMARK.json``, runs its entry, reads its metrics, judges its output.

- ``BENCHMARK.json`` names the cell's configuration (its ``file``), its
  traffic (``benchmark/traffic/<traffic>.json``) and the metrics that apply
  to it (those without a ``workloads`` key, and those whose list names it);
- ``benchmark/limits/<cell>.json``: the limit of each number compared;
- ``benchmark/entries/<entry>.py`` (the traffic's ``entry``): ``run()``,
  which returns the run's record;
- ``benchmark/metrics/<metric>.py``: ``read(record)``, a number or None
  where the record holds nothing to read (the metric is then left out).

A new cell, configuration, entry or metric is a new file and a new entry
in ``BENCHMARK.json``; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = "BENCHMARK.json"
#: top-level modules no run may hold once its window has closed: the JAX
#: stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "spectralae")


def _json(path: Path):
    return json.loads(path.read_text())


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(name: str) -> dict:
    """Everything the harness knows of cell ``name``."""
    manifest = _json(ROOT / MANIFEST)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {MANIFEST} "
                         f"(have: {', '.join(cells)})")
    wl = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    return {"name": name, "chips": wl["chips"],
            "config": _json(ROOT / conf["file"]),
            "traffic": _json(HERE / "traffic" / f"{wl['traffic']}.json"),
            "limits": _json(HERE / "limits" / f"{name}.json"),
            "metrics": {kind: [m for m in manifest[kind]
                               if _applies(m, name)]
                        for kind in ("end_to_end", "per_layer")}}


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``, imported by its path."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def judge(numbers: dict, limits: dict) -> bool:
    """Every limit's number is there, finite and within it."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= lim for k, lim in limits.items())


def power_limit_w() -> float | None:
    """The card's power limit by ``nvidia-smi``, or None where it says
    nothing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    """Run the cell once; returns the result line's object."""
    import torch
    entry = load_module("entries", cell["traffic"]["entry"])
    rec = entry.run(cell, seed=seed, seconds=seconds, trace=trace,
                    device=device, t0=t0)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell["metrics"][kind]:
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": judge(rec["numbers"], cell["limits"]),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": dev}
    if trace and rec["trace"] is not None:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        from benchmark import trace as tracing
        out["breakdown"] = tracing.breakdown(rec["trace"])
    out["card"] = {"power_limit_w": power_limit_w() if cuda else None,
                   "torch": torch.__version__,
                   "reference_s": rec["reference_s"]}
    out["checks"] = {k: {"value": _plain(rec["numbers"].get(k)),
                         "limit": lim}
                     for k, lim in cell["limits"].items()}
    return out


def _plain(v):
    """A number for the JSON line; one that is not finite as its name."""
    return v if v is not None and math.isfinite(v) else str(v)


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among ``sys.modules``."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def emit(result: dict) -> None:
    """Each number compared beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for k, v in result["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
