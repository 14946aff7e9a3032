"""Ahead-of-time model export for serving (``torch.export`` / ``.pt2``).

Port of :mod:`spectralae.io.export`.  The forward (or encoder-only) pass
is traced once with ``torch.export`` on the device the weights are on and
saved as a ``.pt2`` program beside a JSON manifest.  A server process loads
and calls it without tracing and without the model source, on a device
chosen at load time among the artifact's ``platforms``.

The hand-written kernels are nodes of the traced graph: K1 as the operator
``spectralae_torch::cmul_contract`` and the pooling's remap as
``spectralae_torch::spectral_resize`` on the fft path, K2 as
``spectralae_torch::conv_valid`` on the coord path at its kernel shapes
(:mod:`spectralae_torch.ops.spectral_kernels`,
:mod:`spectralae_torch.ops.resize_kernels`,
:mod:`spectralae_torch.ops.coord_kernels`).  Each operator's CPU kernel is
its plain version and its CUDA kernel the launch, so one program runs on
either device — the port's counterpart of JAX's multi-platform lowering.

Artifact layout (a directory)::

    manifest.json      what/domain/shapes/platforms/spec, format version —
                       the JAX artifact's keys, plus the stage scales
    <what>.pt2         torch.export.save of the traced program

Weights are baked into the program as buffers (a serving snapshot, not a
training checkpoint — use :mod:`spectralae_torch.io.checkpoint` for
those).  The batch dimension can be exported symbolically (``batch=None``)
so one artifact serves any batch size.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from ..core.types import AEParams, ConvStage, NetSpec
from ..model import autoencoder as model
from ..ops.dft import ieee_f32

#: 1 was a manifest and ``weights.npz``, the forward rebuilt at load time;
#: 2 is a manifest and a ``.pt2`` program
FORMAT_VERSION = 2

_WHAT = ("forward", "encode")
#: the device types an artifact may list: each has a kernel of both
#: operators
PLATFORMS = ("cpu", "cuda")


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


class _Traced(torch.nn.Module):
    """:func:`_build_fn`'s function as a module whose buffers are the
    stages' weights (``c0``, ``b0``, ``c1``, …), the form ``torch.export``
    traces and saves."""

    def __init__(self, params: AEParams, spec: NetSpec, what: str,
                 domain: str, tap_mode: str):
        super().__init__()
        for i, st in enumerate(params.stages):
            self.register_buffer(f"c{i}", st.c.detach())
            self.register_buffer(f"b{i}", st.b.detach())
        self._n = params.n_stages
        self._how = (spec, what, domain, tap_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = AEParams(stages=tuple(
            ConvStage(c=getattr(self, f"c{i}"), b=getattr(self, f"b{i}"))
            for i in range(self._n)))
        return _build_fn(params, *self._how)(x)


def resolve_platforms(platforms, traced_on: torch.device) -> list[str]:
    """The manifest's ``platforms``: ``platforms`` without repeats, each
    checked against :data:`PLATFORMS`, or ``[traced_on.type]`` for
    ``None``."""
    if platforms is None:
        return [traced_on.type]
    out = list(dict.fromkeys(platforms))
    bad = [p for p in out if p not in PLATFORMS]
    if bad or not out:
        raise ValueError(f"platforms must be drawn from {PLATFORMS}, got "
                         f"{tuple(platforms)}")
    return out


def export_model(params: AEParams, spec: NetSpec, path: str | Path, *,
                 what: str = "forward", domain: str = "fft",
                 batch: int | None = None,
                 platforms: tuple[str, ...] | None = None,
                 tap_mode: str | None = None,
                 extra: dict | None = None) -> Path:
    """Export an ahead-of-time serving artifact.

    The function is traced with ``torch.export`` under ``torch.no_grad()``
    on the device of ``params``.

    Args:
      what: ``"forward"`` (full reconstruction) or ``"encode"``
        (bottleneck features — the serving path).
      domain: ``"fft"`` or ``"coord"`` compute domain.
      batch: fixed batch size, or ``None`` for a symbolic batch dimension
        (one artifact serves any batch size; traced at batch 2, since
        ``torch.export`` specialises sizes 0 and 1).
      platforms: device types the artifact may be loaded on, drawn from
        ``("cpu", "cuda")``; ``None`` = the device it was traced on.
      tap_mode: coord-domain tap window.  ``None`` defaults to
        ``"ref_gpu"`` — the window the interactive engine trains with by
        default (gpu flag on), so an exported coord model computes the
        same convolution as the runtime that produced its weights.  Pass
        ``"ref_cpu"``/``"centered"`` for nets trained with those taps.
        Ignored for ``domain="fft"``.

    Returns the artifact directory path.
    """
    if what not in _WHAT:
        raise ValueError(f"what must be one of {_WHAT}, got {what!r}")
    if domain not in ("fft", "coord"):
        raise ValueError(f"domain must be 'fft' or 'coord', got {domain!r}")
    if tap_mode is None:
        tap_mode = "ref_gpu"
    device = params.stages[0].c.device
    platforms = resolve_platforms(platforms, device)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)

    x = torch.zeros((2 if batch is None else batch, spec.d, spec.nx,
                     spec.ny), device=device)
    dynamic = (None if batch is not None
               else ({0: torch.export.Dim("b", min=1)},))
    module = _Traced(params, spec, what, domain, tap_mode)
    with torch.no_grad():
        # one eager call first fills the caches of constant tensors (the
        # resize maps, the DFT bases: _kernels.tensor_cache), so that the
        # trace records each as a constant, not as a copy made every call
        module(x)
        program = torch.export.export(module, (x,), dynamic_shapes=dynamic)
    torch.export.save(program, path / f"{what}.pt2")

    manifest = {
        "format_version": FORMAT_VERSION,
        "what": what,
        "domain": domain,
        "tap_mode": tap_mode,
        "batch": batch,
        "dtype": "float32",
        "input_shape": [spec.d, spec.nx, spec.ny],
        "platforms": platforms,
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
    """A loaded ``.pt2`` artifact, callable without the model source.

    ``ServingModel.load(path, device)`` reads the manifest and the program
    and moves the program to ``device``; ``__call__`` runs it on a
    ``[B, D, Nx, Ny]`` batch under ``torch.inference_mode()`` with float32
    matmuls and convolutions in IEEE float32 (B must match the exported
    batch unless it was exported with ``batch=None``).  A numpy batch gives
    a numpy result; a tensor gives a tensor on the model's device.
    """

    def __init__(self, program: torch.export.ExportedProgram,
                 manifest: dict, device: torch.device | str):
        self.manifest = manifest
        self.device = torch.device(device)
        self._fn = program.module()

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
        version = manifest["format_version"]
        if version == 1:
            raise ValueError(
                f"{path} is a format-1 artifact (weights.npz, the forward "
                "rebuilt at load time); re-export it (export_model, or the "
                f"export command) to format {FORMAT_VERSION}, a .pt2 program")
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported export format version {version}")
        device = torch.device(device)
        if device.type not in manifest["platforms"]:
            raise ValueError(
                f"{path} was exported for platforms {manifest['platforms']}, "
                f"not {device.type} (re-export with --platforms naming it)")
        # the program calls the kernels' operators: register them first
        from ..ops import (coord_kernels, resize_kernels,  # noqa: F401
                           spectral_kernels)
        program = torch.export.load(path / f"{manifest['what']}.pt2")
        program = move_to_device_pass(program, device)
        return cls(program, manifest, device)

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
        # the trace does not record the TF32 switches the forward sets:
        # hold the library's matmuls and convolutions in float32 here
        with torch.inference_mode(), ieee_f32():
            if isinstance(x, torch.Tensor):
                return self._fn(x.to(self.device, torch.float32))
            t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            return self._fn(t.to(self.device)).cpu().numpy()
