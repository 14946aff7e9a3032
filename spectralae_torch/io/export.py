"""Model export for serving: a manifest plus the weights.

Port of :mod:`spectralae.io.export`.  The JAX package serializes a traced
StableHLO program; this port writes the weights instead and rebuilds the
forward (or encoder-only) pass at load time, on the device the server asks
for.  Ahead-of-time ``torch.export`` artifacts come with ROADMAP A14.

Artifact layout (a directory)::

    manifest.json      what/domain/shapes/platforms/spec, format version —
                       the JAX artifact's keys, plus the stage scales
    weights.npz        stage{i}/c, stage{i}/b — the checkpoint's array names
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..core.types import AEParams, NetSpec, params_from_numpy, spec_of
from ..model import autoencoder as model

FORMAT_VERSION = 1

_WHAT = ("forward", "encode")


def _build_fn(params: AEParams, spec: NetSpec, what: str, domain: str,
              tap_mode: str):
    scales = spec.scales
    if what == "forward":
        if domain == "fft":
            return lambda x: model.forward_fft(params, x, scales)
        return lambda x: model.forward_coord(params, x, scales,
                                             tap_mode=tap_mode)[-1]
    if what == "encode":
        return lambda x: model.encode(params, x, scales, domain=domain,
                                      tap_mode=tap_mode)
    raise ValueError(f"what must be one of {_WHAT}, got {what!r}")


def export_model(params: AEParams, spec: NetSpec, path: str | Path, *,
                 what: str = "forward", domain: str = "fft",
                 batch: int | None = None,
                 tap_mode: str | None = None,
                 extra: dict | None = None) -> Path:
    """Write a serving artifact.

    Args:
      what: ``"forward"`` (full reconstruction) or ``"encode"``
        (bottleneck features).
      domain: ``"fft"`` or ``"coord"`` compute domain.
      batch: fixed batch size, or ``None`` for any batch size.
      tap_mode: coord-domain tap window.  ``None`` defaults to
        ``"ref_gpu"`` — the window the interactive engine trains with by
        default, so an exported coord model computes the same convolution
        as the runtime that produced its weights.  Ignored for
        ``domain="fft"``.

    Returns the artifact directory path.
    """
    if what not in _WHAT:
        raise ValueError(f"what must be one of {_WHAT}, got {what!r}")
    if domain not in ("fft", "coord"):
        raise ValueError(f"domain must be 'fft' or 'coord', got {domain!r}")
    if tap_mode is None:
        tap_mode = "ref_gpu"
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for i, st in enumerate(params.stages):
        arrays[f"stage{i}/c"] = st.c.detach().cpu().numpy()
        arrays[f"stage{i}/b"] = st.b.detach().cpu().numpy()
    np.savez(path / "weights.npz", **arrays)
    manifest = {
        "format_version": FORMAT_VERSION,
        "what": what,
        "domain": domain,
        "tap_mode": tap_mode,
        "batch": batch,
        "dtype": "float32",
        "input_shape": [spec.d, spec.nx, spec.ny],
        "platforms": ["cuda"],
        "spec": {
            "nx": spec.nx, "ny": spec.ny, "d": spec.d,
            "n_stages": len(spec.stages),
            "scales": list(spec.scales),
        },
        "extra": extra or {},
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return path


class ServingModel:
    """An exported model, rebuilt on one device and callable on batches.

    ``ServingModel.load(path, device)`` reads the manifest + weights;
    ``__call__`` runs the forward on a ``[B, D, Nx, Ny]`` batch under
    ``torch.inference_mode()`` (B must match the exported batch unless it
    was exported with ``batch=None``).  A numpy batch gives a numpy result;
    a tensor gives a tensor on the model's device.
    """

    def __init__(self, params: AEParams, spec: NetSpec, manifest: dict,
                 device: torch.device | str):
        self.manifest = manifest
        self.device = torch.device(device)
        self._fn = _build_fn(params, spec, manifest["what"],
                             manifest["domain"], manifest["tap_mode"])

    @classmethod
    def load(cls, path: str | Path,
             device: torch.device | str = "cuda") -> "ServingModel":
        path = Path(path)
        if not (path / "manifest.json").exists():
            # an `export --what both` root holds per-function subdirs;
            # prefer the forward artifact, else the single subdir present
            for sub in ("forward", "encode"):
                if (path / sub / "manifest.json").exists():
                    path = path / sub
                    break
        manifest = json.loads((path / "manifest.json").read_text())
        if manifest["format_version"] != FORMAT_VERSION:
            raise ValueError("unsupported export format version "
                             f"{manifest['format_version']}")
        sm = manifest["spec"]
        with np.load(path / "weights.npz") as data:
            params = params_from_numpy(
                [(data[f"stage{i}/c"], data[f"stage{i}/b"])
                 for i in range(sm["n_stages"])], device=device)
        spec = spec_of(params, sm["nx"], sm["ny"], sm["d"],
                       tuple(sm["scales"]))
        return cls(params, spec, manifest, device)

    @property
    def input_shape(self) -> tuple:
        return tuple(self.manifest["input_shape"])

    def __call__(self, x):
        d, nx, ny = self.input_shape
        if x.ndim != 4 or tuple(x.shape[1:]) != (d, nx, ny):
            raise ValueError(
                f"expected input [B, {d}, {nx}, {ny}], got {tuple(x.shape)}")
        want_b = self.manifest["batch"]
        if want_b is not None and x.shape[0] != want_b:
            raise ValueError(
                f"artifact was exported for batch={want_b}, got "
                f"{x.shape[0]} (re-export with batch=None for an "
                "any-batch artifact)")
        with torch.inference_mode():
            if isinstance(x, torch.Tensor):
                return self._fn(x.to(self.device, torch.float32))
            t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            return self._fn(t.to(self.device)).cpu().numpy()
