"""Build and load the hand-written CUDA kernels (``csrc/*.cu``), and the
one seam through which Python reaches them.

Every ``.cu`` file under ``csrc/`` is compiled by its own ``nvcc`` process,
all started together, for ``sm_90a`` (Hopper); one more ``nvcc`` links the
objects into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \\
         -Xcompiler -fPIC -o <name>.o csrc/<name>.cu        # one per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/spectralae_torch/kernels-<hash>.so *.o

The output lands in ``build/spectralae_torch/`` at the checkout root, named
by a hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused.  The library is loaded with :mod:`ctypes`; each C
entry point takes its pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()`` after its launches.  :func:`launch` is the one way
the kernel modules (``ops/*_kernels.py``) call an entry point: on the
tensors' card, on its current stream, the error checked and the launch
counted under its name in :data:`LAUNCHES`.  ``omega_scratch_floats`` and
``ydft_energy_blocks`` (host-side size queries) and ``dft_leaf_attrs``,
``ydft_sweep_attrs`` and ``omega_tc_attrs`` (the runtime's attributes of
the tensor-core kernels) launch nothing and are called on :func:`lib`.

There is no fallback: a missing ``nvcc``, a failed build or a failed launch
raises.  The kernels' plain PyTorch versions run only for CPU tensors, and
that choice is made by the wrappers, never here.  :func:`kernel_route`
says which tensors take a kernel's route; :func:`operator` registers a
kernel as a ``torch.library`` operator, so that a traced graph holds it as
one node.

:func:`opaque` marks each kernel's wrapper (the function that launches the
kernel on a CUDA tensor and runs its plain version on a CPU one), so that
a caller may see each of its calls as one unit on either device
(:data:`HOOK`), and the recorder counts them.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .core import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
#: streaming multiprocessors of the card the launch plans are sized for
#: (NVIDIA H100 SXM, the sm_90a target)
NUM_SMS = 132
#: the grid's y and z limit
GRID_YZ = 65535
BUILD_DIR = CSRC.parent.parent / "build" / "spectralae_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points (see the .cu files); every one returns
# the cudaError_t of its launch
_SIGNATURES = {
    # p, q, out, A, K, B, W, p_stride_a, p_stride_k, q_stride_k,
    # q_stride_b, conj_q, p_scale, bias, bias_scale, vec, group, rows,
    # stream
    "cmul_contract_launch": (_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L, _I,
                             _F, _P, _F, _I, _I, _I, _P),
    # the same, p and q bf16 (re, im) pairs
    "cmul_contract_bf16_launch": (_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L,
                                  _I, _F, _P, _F, _I, _I, _I, _P),
    # K1's blocked design: the same operands, then vec, na, nb, kc,
    # stages, grid, smem, stream; and with bf16 pairs
    "cmul_contract_blocked_launch": (_P, _P, _P, _I, _I, _I) + (_L,) * 5
    + (_I, _F, _P, _F) + (_I,) * 7 + (_P,),
    "cmul_contract_blocked_bf16_launch": (_P, _P, _P, _I, _I, _I) + (_L,) * 5
    + (_I, _F, _P, _F) + (_I,) * 7 + (_P,),
    # xpad, w, out, B, D, Hp, Wp, M, nk, nl, tx, ty, mb, vec, stream
    "conv_valid_launch": (_P, _P, _P) + (_I,) * 11 + (_P,),
    # X, Z, consts, out, scratch, scratch_floats, B, D, E, nx, nyr, hx, hy,
    # same, rows, batches, ychunk, ytile, smem, stream
    "corr_pair_windows_launch": (_P,) * 5 + (_L,) + (_I,) * 13 + (_P,),
    # X, xre, xim, taps, consts, out, scratch, scratch_floats, B, D, nx,
    # nx_l, row0, nyr, nk2, nl2, s1, bf16, rows, batches, ychunk, ytile,
    # smem, stream
    "anchor_windows_launch": (_P,) * 7 + (_L,) + (_I,) * 8 + (_F,)
    + (_I,) * 6 + (_P,),
    # xr, xi, consts, tiles, outr, outi, BD, R, n, k1p, tier, tf, jc,
    # stream
    "rfft_y_leaf_launch": (_P,) * 6 + (_I,) * 7 + (_P,),
    # yr, yi, consts, tiles, outr, outi, BD, nx, L, bf16, tier, tf, jc,
    # stream
    "fft_x_leaf_launch": (_P,) * 6 + (_I,) * 7 + (_P,),
    # variant, tier, out[4]
    "dft_leaf_attrs": (_I, _I, _P),
    # xr, xi, consts, outr, outi, BD, A, n, lanes, stream
    "bfly_round_launch": (_P,) * 5 + (_I,) * 4 + (_P,),
    # kind, nb, M, D, P, W (returns long long)
    "omega_scratch_floats": (_I,) * 6,
    # planes, tiles, wv, cf, b, out, dbdp, scratch, tickets, nb, M, D, P, W,
    # norm, scale, bf16, stream
    "omega_grad_project_launch": (_P,) * 9 + (_I,) * 5 + (_F, _F, _I, _P),
    # kind (0 K5, 1 K7, 2 K6, 3 K8), bf16, D, out[4]
    "omega_tc_attrs": (_I, _I, _I, _P),
    # planes, tiles, wv, cf, b, p, o_out, mse_out, scratch, tickets, nb, M,
    # D, P, W, norm, inv_m, inv_d, bf16, stream
    "omega_respectra_launch": (_P,) * 10 + (_I,) * 5 + (_F,) * 3 + (_I, _P),
    # planes, tiles, wv, cf, b, p, o_out, out, dbdp, scratch, tickets, nb,
    # M, D, P, W, norm, inv_m, inv_d, scale, bf16, stream
    "omega_fused_step_launch": (_P,) * 11 + (_I,) * 5 + (_F,) * 4 + (_I, _P),
    # planes, tiles, wv, state_in, state_out, mse_out, scratch, nb, M, D, P,
    # W, iters, norm, inv_m, inv_d, scale, lr_eff, alpha, bf16, stream
    "omega_itergrid_launch": (_P,) * 7 + (_I,) * 6 + (_F,) * 6 + (_I, _P),
    # x, out, rows, in_cols, out_cols, stream
    "probe_lane_strided_launch": (_P, _P, _I, _I, _I, _P),
    # x, out, out_rows, cols, stream
    "probe_sublane_strided_launch": (_P, _P, _I, _I, _P),
    # x, out, n, K, stream
    "probe_middle_store_launch": (_P, _P, _L, _I, _P),
    # R, nyr (returns long long)
    "ydft_energy_blocks": (_I, _I),
    # x, tiles, w, scratch, out, R, ny, nyr, tier, tb, ty, stream
    "ydft_energy_launch": (_P,) * 5 + (_I,) * 6 + (_P,),
    # tier, out[4]
    "ydft_sweep_attrs": (_I, _P),
    # in, out, rows, planes, h_in, w_in, h_out, w_out, k, stream
    "spectral_resize_launch": (_P, _P, _P, _L) + (_I,) * 5 + (_P,),
}
# entry points that return something other than a cudaError_t
_RESTYPES = {"omega_scratch_floats": ctypes.c_longlong,
             "ydft_energy_blocks": ctypes.c_longlong}


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
            tag = f"{out.stem}.{os.getpid()}"
            nvcc = _nvcc()
            t0 = time.perf_counter()
            objs, procs = [], []
            for src in sorted(CSRC.glob("*.cu")):
                obj = BUILD_DIR / f"{tag}.{src.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(obj), str(src)]
                objs.append(obj)
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs = []
            try:
                for cmd, proc in procs:
                    text = proc.communicate()[0]
                    logs.append(text)
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed ({proc.returncode}):\n"
                            f"{' '.join(cmd)}\n{text}")
            finally:
                for _, proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            tmp = out.with_name(f"{tag}.tmp")
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *(str(o) for o in objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = "".join(logs) + proc.stdout + proc.stderr
            for obj in objs:
                obj.unlink(missing_ok=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
            os.replace(tmp, out)    # atomic: concurrent builders agree
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _build = KernelBuild(lib, out, seconds, log)
        return _build


def lib() -> ctypes.CDLL:
    return build().lib


def cdiv(n: int, d: int) -> int:
    """Ceiling division, for the launch plans."""
    return -(-n // d)


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream of ``device``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


#: kernel launches since import, by launch name: one per call of
#: :func:`launch`, whose C entry point may run more than one grid
LAUNCHES: collections.Counter = collections.Counter()


def launch(entry: str, name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current stream
    of ``device`` (a CUDA device), raise on the error it returns, and count
    the launch under ``name`` in :data:`LAUNCHES`.  The launch runs on
    ``device``: the current device is switched for it only where it is
    another (the switch and back cost about 5 host microseconds).  Names
    tell apart what an entry point does for several kernels (K1's designs
    and operand types, the butterfly rounds along lanes and rows)."""
    fn = getattr(lib(), entry)
    if device.index == torch._C._cuda_getDevice():
        err = fn(*args, stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream(device))
    check(err, name)
    LAUNCHES[name] += 1


def operator(name: str, schema: str, cpu, cuda, fake):
    """Register the kernel ``spectralae_torch::<name>`` as a
    ``torch.library.custom_op`` with its CPU kernel ``cpu`` (the plain
    version), its CUDA kernel ``cuda`` (the launch) and its fake version
    ``fake``, and return the function that calls it.

    While a graph is traced (``torch.export``, ``torch.compile``) that
    function calls the operator, so the graph holds it as one node.  In
    eager code it calls the kernel for the device of its first argument
    directly: the same body without the dispatcher's cost, paid on every
    launch of the eager paths.  The function carries the operator as
    ``op`` and its kernels by device type as ``kernels``."""
    op = torch.library.custom_op(f"spectralae_torch::{name}", cpu,
                                 mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda", cuda)
    op.register_fake(fake)
    kernels = {"cpu": cpu, "cuda": cuda}

    def call(*args):
        if torch.compiler.is_compiling():
            return op(*args)
        return kernels[args[0].device.type](*args)
    call.op, call.kernels = op, kernels
    return call


#: None, or a callable ``hook(fn, args, kwargs)`` that every call of a
#: kernel's wrapper (:func:`opaque`) goes through instead, returning what
#: the call returns.  Process-wide, not thread-local: autograd runs a CUDA
#: backward's kernel calls on its own device threads, which must see it;
#: whoever sets it clears it in a ``finally`` (one hook at a time).
HOOK = None


def kernel_route(x: torch.Tensor) -> bool:
    """Whether ``x`` takes a hand-written kernel's route (K1 in
    :func:`spectralae_torch.ops.spectral.spectral_conv`, K2 in
    :func:`spectralae_torch.ops.coord.conv2d`, the resize in
    :func:`spectralae_torch.ops.spectral.spectral_resize`): a CUDA tensor,
    or a tensor on either device while ``torch.export`` traces — the graph
    then holds the kernel's operator, which runs the kernel on the card and
    its plain version on the CPU (the port's counterpart of JAX's
    multi-platform lowering) — or while a :data:`HOOK` sees every kernel
    wrapper's call, so that it meets the same kernel calls on either
    device."""
    return x.is_cuda or torch.compiler.is_exporting() or HOOK is not None


def tensor_cache(fn):
    """A cache for a function that builds constant tensors, which stores
    nothing while ``torch.export`` traces: a tensor made under the trace's
    fake mode holds no data, and a cache that kept one would hand it to
    every later eager call in the process.  A tensor cached before the
    trace is returned to it as it is, and the trace records it as one
    constant of the program (:func:`spectralae_torch.io.export.export_model`
    fills the caches by an eager call first); one built during the trace
    is recorded as a copy made at every call."""
    cache = {}

    @functools.wraps(fn)
    def get(*args):
        out = cache.get(args)
        if out is None:
            out = fn(*args)
            if not torch.compiler.is_exporting():
                cache[args] = out
        return out
    get.cache_clear = cache.clear
    return get


#: how deep this thread is inside kernel wrappers' calls the recorder counts
_depth = threading.local()


def opaque(fn):
    """Mark ``fn`` as a kernel's wrapper: called as it is, or, while a
    :data:`HOOK` is set, through ``HOOK(fn, args, kwargs)``.  While the
    recorder is on (:mod:`spectralae_torch.core.profiling`), each call
    counts under ``kernel.<name>``; a wrapper that another wrapper calls is
    part of the outer call, as the roofline tally's boundary counts it."""
    name = "kernel." + fn.__name__

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if profiling.recording and not getattr(_depth, "n", 0):
            profiling.count(name)
            _depth.n = 1
            try:
                return call(*args, **kwargs)
            finally:
                _depth.n = 0
        hook = HOOK
        if hook is None:
            return fn(*args, **kwargs)
        return hook(fn, args, kwargs)
    return call
