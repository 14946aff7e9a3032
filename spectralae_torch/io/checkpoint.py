"""Checkpoints in the JAX package's manifest+npz format.

Port of the native format of :mod:`spectralae.io.checkpoint`: a directory
with a JSON manifest (shapes, dtypes, scales, config) + one ``arrays.npz``
of all arrays.  Both sides are plain numpy, so a checkpoint written by the
JAX package loads here and the reverse.  Shape metadata travels with the
payload, so mismatched loads fail loudly.

Not ported yet (ROADMAP A10): optimizer state (a JAX training checkpoint's
``mom*``/``pg*`` arrays are left unread), the reference ``.conv`` shim,
rotating history and asynchronous saves.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..core.types import AEParams, ConvStage, NetSpec, StageSpec

FORMAT_VERSION = 1


def save(path: str | Path, params: AEParams, spec: NetSpec,
         extra: dict | None = None) -> None:
    """Write ``params`` and ``spec`` (no optimizer state) to ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    for i, st in enumerate(params.stages):
        arrays[f"stage{i}/c"] = st.c.detach().cpu().numpy()
        arrays[f"stage{i}/b"] = st.b.detach().cpu().numpy()
    np.savez(path / "arrays.npz", **arrays)
    manifest = {
        "format_version": FORMAT_VERSION,
        "n_stages": len(params.stages),
        "has_opt": False,
        "spec": {
            "nx": spec.nx, "ny": spec.ny, "d": spec.d,
            "stages": [dataclasses.asdict(s) for s in spec.stages],
        },
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "extra": extra or {},
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=2))


def resolve(path: str | Path) -> Path:
    """Resolve a checkpoint argument to a concrete checkpoint directory —
    either the directory itself or, for a rotation root, the directory its
    ``LATEST`` marker points at."""
    path = Path(path)
    if not (path / "manifest.json").exists() and (path / "LATEST").exists():
        return path / (path / "LATEST").read_text().strip()
    return path


def load(path: str | Path, *, device: torch.device | str = "cpu"):
    """Returns ``(params, spec, None, extra)``, params on ``device``.

    The third slot is the JAX loader's optimizer state; the port does not
    read it yet, so it is always ``None``.
    """
    path = resolve(path)
    manifest = json.loads((path / "manifest.json").read_text())
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version "
                         f"{manifest['format_version']}")
    with np.load(path / "arrays.npz") as data:
        for k, shape in manifest["shapes"].items():
            if list(data[k].shape) != shape:
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{data[k].shape} != {shape}")
        n = manifest["n_stages"]
        params = AEParams(stages=tuple(
            ConvStage(c=torch.tensor(data[f"stage{i}/c"], device=device),
                      b=torch.tensor(data[f"stage{i}/b"], device=device))
            for i in range(n)))
    sm = manifest["spec"]
    spec = NetSpec(nx=sm["nx"], ny=sm["ny"], d=sm["d"],
                   stages=tuple(StageSpec(**s) for s in sm["stages"]))
    return params, spec, None, manifest.get("extra", {})
