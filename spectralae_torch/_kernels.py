"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every ``.cu`` file under ``csrc/`` is compiled by one ``nvcc`` call into a
shared library with a plain C interface, for ``sm_90a`` (Hopper)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/spectralae_torch/kernels-<hash>.so csrc/*.cu

The output lands in ``build/spectralae_torch/`` at the checkout root, named
by a hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused.  The library is loaded with :mod:`ctypes`; each C
entry point takes its pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()`` after its launch, which :func:`check` turns into an
exception.

There is no fallback: a missing ``nvcc``, a failed build or a failed launch
raises.  The kernels' plain PyTorch versions run only for CPU tensors, and
that choice is made by the wrappers, never here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "spectralae_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points (see the .cu files); every one returns
# the cudaError_t of its launch
_SIGNATURES = {
    # p, q, out, A, K, B, W, p_stride_a, p_stride_k, q_stride_k,
    # q_stride_b, conj_q, p_scale, bias, bias_scale, stream
    "cmul_contract_launch": (_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L, _I,
                             _F, _P, _F, _P),
    # xpad, w, out, B, D, Hp, Wp, M, nk, nl, stream
    "conv_valid_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}


class KernelBuild:
    """A built and loaded kernel library, with what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds      # 0.0 when an earlier build was reused
        self.log = log              # nvcc's -Xptxas=-v report


_lock = threading.Lock()
_build: KernelBuild | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> KernelBuild:
    """Compile (or reuse) and load the kernel library; thread-safe."""
    global _build
    with _lock:
        if _build is not None:
            return _build
        out = BUILD_DIR / f"kernels-{_digest()}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(s) for s in sorted(CSRC.glob("*.cu")))]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
            os.replace(tmp, out)    # atomic: concurrent builders agree
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _build = KernelBuild(lib, out, seconds, log)
        return _build


def lib() -> ctypes.CDLL:
    return build().lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
