"""ctypes bindings to the C++ host runtime (libspectralae_host.so).

A copy of :mod:`spectralae.data.native` (framework-free, so the port keeps
its own): the same library, ``native/build/libspectralae_host.so`` at the
root of the checkout, found from this file's path.

The reference's performance-critical host path — frame repacking between
OpenCV mats and channel-major float tensors (netlib.cpp:37-77), done every
frame — is native C++ there; here the equivalent hot host loops (uint8 HWC ↔
float32 CWH, NN resize, and the fused+threaded batch resize-convert stage
feeding the device prefetcher) live in ``native/host_runtime.cpp``, compiled
to a shared library and bound via ctypes (no pybind11 in this image).  Falls
back to numpy transparently when the library isn't built; build with
``make -C native``.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_LIB_NAMES = ("libspectralae_host.so",)
_lib = None


def _find_lib() -> ctypes.CDLL | None:
    root = Path(__file__).resolve().parents[2]
    candidates = [root / "native" / "build" / n for n in _LIB_NAMES]
    candidates += [root / "native" / n for n in _LIB_NAMES]
    env = os.environ.get("SPECTRALAE_NATIVE_LIB")
    if env:
        candidates.insert(0, Path(env))
    for c in candidates:
        if c.exists():
            try:
                lib = ctypes.CDLL(str(c))
            except OSError:
                continue
            _bind(lib)
            return lib
    return None


def _bind(lib: ctypes.CDLL) -> None:
    u8 = ctypes.POINTER(ctypes.c_uint8)
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.sae_frame_to_tensor.argtypes = [u8, f32, ctypes.c_int, ctypes.c_int]
    lib.sae_frame_to_tensor.restype = None
    lib.sae_tensor_to_frame.argtypes = [f32, u8, ctypes.c_int, ctypes.c_int]
    lib.sae_tensor_to_frame.restype = None
    lib.sae_resize_nn.argtypes = [u8, u8, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
    lib.sae_resize_nn.restype = None
    if hasattr(lib, "sae_batch_to_tensor"):
        lib.sae_batch_to_tensor.argtypes = [u8, f32] + [ctypes.c_int] * 6
        lib.sae_batch_to_tensor.restype = None
    if hasattr(lib, "sae_yuv_to_bgr"):
        lib.sae_yuv_to_bgr.argtypes = [u8, u8, u8, u8] + [ctypes.c_int] * 5
        lib.sae_yuv_to_bgr.restype = None
    if hasattr(lib, "sae_png_unfilter"):
        lib.sae_png_unfilter.argtypes = [u8, u8] + [ctypes.c_int] * 3
        lib.sae_png_unfilter.restype = ctypes.c_int


def available() -> bool:
    global _lib
    if _lib is None:
        _lib = _find_lib()
    return _lib is not None


def _require_hwc3(img: np.ndarray, fn: str) -> None:
    # validated here so malformed input is a ValueError, not an
    # out-of-bounds read in the C loop (same convention as yuv_to_bgr)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{fn} expects [H, W, 3] uint8, got {img.shape}")


def frame_to_tensor(img: np.ndarray) -> np.ndarray:
    _require_hwc3(img, "frame_to_tensor")
    h, w = img.shape[:2]
    img = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty((3, w, h), np.float32)
    _lib.sae_frame_to_tensor(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w)
    return out


def tensor_to_frame(spin: np.ndarray) -> np.ndarray:
    if spin.ndim != 3 or spin.shape[0] != 3:
        raise ValueError(f"tensor_to_frame expects [3, W, H], got {spin.shape}")
    _, w, h = spin.shape
    spin = np.ascontiguousarray(spin, dtype=np.float32)
    out = np.empty((h, w, 3), np.uint8)
    _lib.sae_tensor_to_frame(
        spin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w)
    return out


def has_batch() -> bool:
    """True when the built library exposes the threaded batch stage
    (libraries built before it existed lack the symbol)."""
    return available() and hasattr(_lib, "sae_batch_to_tensor")


def batch_to_tensor(imgs: np.ndarray, nx: int, ny: int,
                    n_threads: int = 0) -> np.ndarray:
    """Fused resize+convert of a uint8 ``[N, H, W, 3]`` frame stack to
    float32 ``[N, 3, nx, ny]`` at the target resolution, one worker thread
    per frame (``n_threads=0`` → one per frame, capped at hardware
    concurrency by the scheduler)."""
    if not has_batch():
        raise RuntimeError("native library not built or lacks "
                           "sae_batch_to_tensor (make -C native)")
    if imgs.ndim != 4 or imgs.shape[3] != 3:
        raise ValueError(f"batch_to_tensor expects [N, H, W, 3], got {imgs.shape}")
    n, h, w = imgs.shape[:3]
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    out = np.empty((n, 3, nx, ny), np.float32)
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 1)
    _lib.sae_batch_to_tensor(
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, h, w, ny, nx, n_threads)
    return out


def has_yuv() -> bool:
    """True when the built library exposes the YUV decode stage."""
    return available() and hasattr(_lib, "sae_yuv_to_bgr")


def yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray,
               sy: int, sx: int, n_threads: int = 0) -> np.ndarray:
    """Planar BT.601 limited-range YUV → uint8 BGR HWC (threaded C++).

    ``y`` is ``[H, W]``; ``u``/``v`` are ``[H//sy, W//sx]`` chroma planes
    (``sy``/``sx`` ∈ {1, 2}: C420/C422/C444), upsampled nearest-neighbor —
    the Y4M file source's per-frame hot loop."""
    if not has_yuv():
        raise RuntimeError("native library not built or lacks "
                           "sae_yuv_to_bgr (make -C native)")
    h, w = y.shape
    if sy not in (1, 2) or sx not in (1, 2) or h < sy or w < sx:
        raise ValueError(f"bad subsampling ({sy},{sx}) for {h}x{w}")
    if u.shape != (h // sy, w // sx) or v.shape != u.shape:
        # validated here so a mismatch is a ValueError, not an
        # out-of-bounds read in the C loop
        raise ValueError(f"chroma planes {u.shape}/{v.shape} do not match "
                         f"y {y.shape} with subsampling ({sy},{sx})")
    y = np.ascontiguousarray(y, dtype=np.uint8)
    u = np.ascontiguousarray(u, dtype=np.uint8)
    v = np.ascontiguousarray(v, dtype=np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    p = ctypes.POINTER(ctypes.c_uint8)
    _lib.sae_yuv_to_bgr(
        y.ctypes.data_as(p), u.ctypes.data_as(p), v.ctypes.data_as(p),
        out.ctypes.data_as(p), h, w, sy, sx, n_threads)
    return out


def has_png_unfilter() -> bool:
    return available() and hasattr(_lib, "sae_png_unfilter")


def png_unfilter(raw: bytes, h: int, w_bytes: int, ch: int) -> np.ndarray:
    """Reverse PNG scanline filters 0-4 (sequential per byte → C).

    ``raw``: ``h·(w_bytes+1)`` bytes of [filter byte + filtered row];
    returns ``[h, w_bytes]`` recovered bytes."""
    if not has_png_unfilter():
        raise RuntimeError("native library not built or lacks "
                           "sae_png_unfilter (make -C native)")
    if len(raw) < h * (w_bytes + 1):
        raise ValueError("raw buffer shorter than h*(w_bytes+1)")
    src = np.frombuffer(raw, np.uint8, h * (w_bytes + 1))
    src = np.ascontiguousarray(src)
    out = np.empty((h, w_bytes), np.uint8)
    p = ctypes.POINTER(ctypes.c_uint8)
    rc = _lib.sae_png_unfilter(src.ctypes.data_as(p),
                               out.ctypes.data_as(p), h, w_bytes, ch)
    if rc != 0:
        raise ValueError(f"unsupported PNG filter type {rc}")
    return out


def resize_nn(img: np.ndarray, nx: int, ny: int) -> np.ndarray:
    _require_hwc3(img, "resize_nn")
    h, w = img.shape[:2]
    img = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty((ny, nx, 3), np.uint8)
    _lib.sae_resize_nn(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, ny, nx)
    return out
