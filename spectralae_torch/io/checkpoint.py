"""Checkpoints in the JAX package's manifest+npz format.

Port of the native format of :mod:`spectralae.io.checkpoint`: a directory
with a JSON manifest (shapes, dtypes, scales, config) + one ``arrays.npz``
of all arrays, the reference optimizer's state included (``mom{i}/c``,
``pg{i}/b``, … and the ``has_opt`` manifest key).  Both sides are plain
numpy, so a training checkpoint written by the JAX package resumes here and
the reverse.  Shape metadata travels with the payload, so mismatched loads
fail loudly.

The ``torch.optim`` optimizers' state goes into a sidecar file of its own,
``optim.pt`` (:func:`save_optim_state`); the JAX package's ``optax.npz``
sidecar holds optax state, which this package does not read.

``.conv`` shim: byte-compatible with the reference's per-stage raw-float32
files (``SaveLoad_conv``/``SaveLoad_vec``, source/netlib.cpp:200-272) and
with the JAX package's — filename
``C_weights_{L}{_in|_out}_D=…_M=…_Lk=…_Ll=…_S=….conv``, payload all kernel
weights in (m,d,k,l) row-major order followed by the M biases.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..core.config import half_extent
from ..core.types import AEParams, ConvStage, NetSpec, OptState, StageSpec

FORMAT_VERSION = 1
OPTIM_SIDECAR = "optim.pt"      # torch.optim state (this package)
OPTAX_SIDECAR = "optax.npz"     # optax state (the JAX package; not read)


def save(path: str | Path, params: AEParams, spec: NetSpec,
         opt: OptState | None = None, extra: dict | None = None) -> None:
    """Write ``params``, ``spec`` and the reference optimizer's ``opt``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    for i, st in enumerate(params.stages):
        arrays[f"stage{i}/c"] = st.c.detach().cpu().numpy()
        arrays[f"stage{i}/b"] = st.b.detach().cpu().numpy()
    if opt is not None:
        for i, st in enumerate(opt.mom.stages):
            arrays[f"mom{i}/c"] = st.c.detach().cpu().numpy()
            arrays[f"mom{i}/b"] = st.b.detach().cpu().numpy()
        for i, st in enumerate(opt.prev_grad.stages):
            arrays[f"pg{i}/c"] = st.c.detach().cpu().numpy()
            arrays[f"pg{i}/b"] = st.b.detach().cpu().numpy()
    np.savez(path / "arrays.npz", **arrays)
    manifest = {
        "format_version": FORMAT_VERSION,
        "n_stages": len(params.stages),
        "has_opt": opt is not None,
        "spec": {
            "nx": spec.nx, "ny": spec.ny, "d": spec.d,
            "stages": [dataclasses.asdict(s) for s in spec.stages],
        },
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "extra": extra or {},
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=2))


_SAVE_POOL: ThreadPoolExecutor | None = None


def save_async(path: str | Path, params: AEParams, spec: NetSpec,
               opt: OptState | None = None,
               extra: dict | None = None) -> Future:
    """Non-blocking :func:`save`: the device→host copy and the file IO run
    on a single background worker (saves stay ordered).  Returns a
    ``Future``; call :func:`wait_pending_saves` before exiting.

    The worker writes exactly the tensors passed in: the train steps of
    :mod:`spectralae_torch.train.modern` never update a tensor in place, so
    training may go on meanwhile.
    """
    global _SAVE_POOL
    if _SAVE_POOL is None:
        _SAVE_POOL = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt-save")
    return _SAVE_POOL.submit(save, path, params, spec, opt, extra)


def wait_pending_saves() -> None:
    """Block until every :func:`save_async` in flight has committed."""
    global _SAVE_POOL
    if _SAVE_POOL is not None:
        _SAVE_POOL.shutdown(wait=True)
        _SAVE_POOL = None


def save_rotating(root: str | Path, params: AEParams, spec: NetSpec,
                  opt: OptState | None = None, extra: dict | None = None,
                  *, step: int, keep: int = 3, extra_files=None) -> Path:
    """Step-stamped checkpoint history: writes ``root/step_{step:08d}``,
    points ``root/LATEST`` at it, prunes to the newest ``keep`` (``keep``
    ≤ 0 keeps all).

    ``extra_files(dest)`` runs after the checkpoint is written but BEFORE
    ``LATEST`` moves, so sidecar files (optimizer state) are committed
    before the checkpoint becomes resolvable.
    """
    root = Path(root)
    dest = root / f"step_{step:08d}"
    save(dest, params, spec, opt, extra={**(extra or {}), "step": step})
    if extra_files is not None:
        extra_files(dest)
    (root / "LATEST").write_text(dest.name)
    # prune by RECENCY (mtime), not name: a divergence rollback re-saves an
    # *earlier* step, and name order would then delete the fresh good
    # checkpoints and keep the diverged ones.  Never the one just written.
    olds = sorted((p for p in root.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and p != dest),
                  key=lambda p: p.stat().st_mtime)
    if keep <= 0:
        doomed = []
    elif keep == 1:
        doomed = olds
    else:
        doomed = olds[:-(keep - 1)]
    for p in doomed:
        shutil.rmtree(p, ignore_errors=True)
    return dest


def resolve(path: str | Path) -> Path:
    """Resolve a checkpoint argument to a concrete checkpoint directory —
    either the directory itself or, for a :func:`save_rotating` root, the
    directory its ``LATEST`` marker points at."""
    path = Path(path)
    if not (path / "manifest.json").exists() and (path / "LATEST").exists():
        return path / (path / "LATEST").read_text().strip()
    return path


def load(path: str | Path, *, device: torch.device | str = "cpu"):
    """Returns ``(params, spec, opt_or_None, extra)``, tensors on ``device``.

    Accepts either a single checkpoint directory or a rotation root
    written by :func:`save_rotating` (resolved through ``LATEST``).
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

        def tape(prefix: str) -> AEParams:
            return AEParams(stages=tuple(
                ConvStage(c=torch.tensor(data[f"{prefix}{i}/c"],
                                         device=device),
                          b=torch.tensor(data[f"{prefix}{i}/b"],
                                         device=device))
                for i in range(n)))
        params = tape("stage")
        opt = (OptState(mom=tape("mom"), prev_grad=tape("pg"))
               if manifest["has_opt"] else None)
    sm = manifest["spec"]
    spec = NetSpec(nx=sm["nx"], ny=sm["ny"], d=sm["d"],
                   stages=tuple(StageSpec(**s) for s in sm["stages"]))
    return params, spec, opt, manifest.get("extra", {})


# ------------------------------------------------- torch.optim opt state

def save_optim_state(path: str | Path, state: dict) -> None:
    """Persist an :class:`~spectralae_torch.train.modern.Optimizer` state
    (its update count and the torch optimizer's ``state_dict``)."""
    torch.save(state, Path(path))


def load_optim_state(path: str | Path) -> dict:
    """Read a state written by :func:`save_optim_state` onto the CPU
    (tensors and plain values only: ``weights_only`` loading).  The torch
    optimizer moves it to its parameters' device when it loads it."""
    return torch.load(Path(path), map_location="cpu", weights_only=True)


# ------------------------------------------------------------------ .conv shim

def conv_filename(level: int, io: int, d: int, m: int, nk: int, nl: int,
                  scale: int) -> str:
    """The reference's shape-in-the-filename scheme (netlib.cpp:230-234)."""
    inout = "_in" if io == 0 else "_out"
    return (f"C_weights_{level}{inout}_D={d}_M={m}"
            f"_Lk={half_extent(nk)}_Ll={half_extent(nl)}_S={scale}.conv")


def export_conv(stage: ConvStage, path: str | Path) -> None:
    """Write one stage in reference binary layout (netlib.cpp:236-253)."""
    with open(path, "wb") as fh:
        for t in (stage.c, stage.b):   # (m,d,k,l) row-major, then biases
            fh.write(t.detach().cpu().contiguous().numpy()
                     .astype("<f4").tobytes())


def import_conv(path: str | Path, m: int, d: int, nk: int, nl: int, *,
                device: torch.device | str = "cpu") -> ConvStage:
    """Read one reference-format stage file (netlib.cpp:254-271) onto
    ``device``.  Shapes come from the caller (in the reference, from the
    filename); a file of another float count is refused."""
    raw = np.fromfile(path, dtype="<f4")
    want = m * d * nk * nl + m
    if raw.size != want:
        raise ValueError(f"{path}: expected {want} floats, got {raw.size}")
    raw = torch.from_numpy(raw.astype(np.float32)).to(device)
    return ConvStage(c=raw[: m * d * nk * nl].reshape(m, d, nk, nl),
                     b=raw[m * d * nk * nl:])


def _pair_paths(params: AEParams, spec: NetSpec, n_l: int,
                weights_dir: Path) -> tuple[Path, Path]:
    n = len(params.stages)
    enc, dec = params.pair(n_l)
    enc_spec, dec_spec = spec.stages[n_l], spec.stages[n - 1 - n_l]
    return (weights_dir / conv_filename(n_l, 0, enc.d, enc.m, enc.nk, enc.nl,
                                        enc_spec.scale),
            weights_dir / conv_filename(n_l, 1, dec.d, dec.m, dec.nk, dec.nl,
                                        dec_spec.scale))


def save_pair_conv(params: AEParams, spec: NetSpec, n_l: int,
                   weights_dir: str | Path) -> tuple[Path, Path]:
    """'s' key semantics: save the selected stage pair
    (source/autoencoder.cpp:358-369)."""
    weights_dir = Path(weights_dir)
    weights_dir.mkdir(parents=True, exist_ok=True)
    p_enc, p_dec = _pair_paths(params, spec, n_l, weights_dir)
    enc, dec = params.pair(n_l)
    export_conv(enc, p_enc)
    export_conv(dec, p_dec)
    return p_enc, p_dec


def load_pair_conv(params: AEParams, spec: NetSpec, n_l: int,
                   weights_dir: str | Path) -> AEParams:
    """'l' key semantics: load the selected stage pair
    (source/autoencoder.cpp:370-383) onto the device its weights are on."""
    p_enc, p_dec = _pair_paths(params, spec, n_l, Path(weights_dir))
    enc, dec = params.pair(n_l)
    return params.replace_pair(
        n_l, import_conv(p_enc, enc.m, enc.d, enc.nk, enc.nl,
                         device=enc.c.device),
        import_conv(p_dec, dec.m, dec.d, dec.nk, dec.nl,
                    device=dec.c.device))
