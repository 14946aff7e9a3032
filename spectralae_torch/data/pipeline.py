"""Host input pipeline: frame sources, codecs, and device prefetch.

Port of :mod:`spectralae.data.pipeline`: the codecs, the frame sources
(synthetic, ``.npy``/``.npz``, ``.y4m``, a directory of PNGs, and through
OpenCV, imported only when asked for, the camera and any video file),
nearest-neighbour resize, and a prefetcher that copies each batch to the
device from pinned host memory on its own CUDA stream while the device
computes on the previous one.  All of it is host code on numpy arrays.
When the C++ native library (:mod:`spectralae_torch.data.native`) is built
it takes the stages it runs faster than numpy
(``scripts/torch_host_route_bench.py``): the resize, the prefetcher's
batch stage, the ``.y4m`` colour conversion and the PNG unfilter.
``frame_to_tensor`` and ``tensor_to_frame`` stay on numpy, which runs them
faster; the JAX package routes those two to the library as well.

Codec parity: ``ImageToSpin_C`` (netlib.cpp:37-51) indexes ``spin[c][i][j] =
img.at(j, i)[c]`` — the tensor's first spatial axis is the image *column*
(i over Nx = img.cols), and values stay in 0..255 (no /255, netlib.cpp:46).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from . import native as _native


# --------------------------------------------------------------------- codecs

def frame_to_tensor(img: np.ndarray) -> np.ndarray:
    """uint8 ``[H, W, 3]`` (BGR) → float32 ``[3, W, H]`` in 0..255.

    Reference: ``ImageToSpin_C`` netlib.cpp:37-51 (note the j,i transpose —
    the spin tensor is column-major in the image sense)."""
    return np.ascontiguousarray(
        img.astype(np.float32).transpose(2, 1, 0))


def tensor_to_frame(spin: np.ndarray) -> np.ndarray:
    """float32 ``[3, W, H]`` → uint8 ``[H, W, 3]`` with round + clamp to
    [0, 255] (reference: ``SpinToImage_C`` netlib.cpp:54-77)."""
    img = np.clip(np.round(spin.transpose(2, 1, 0)), 0, 255)
    return img.astype(np.uint8)


def feature_to_image(fmap: np.ndarray) -> np.ndarray:
    """Feature map ``[W, H]`` → uint8 grayscale, *unclamped* truncating cast
    (reference: ``SpinToImage_V`` netlib.cpp:80-94 — overflow wraps, a quirk
    kept for display parity)."""
    return fmap.T.astype(np.int64).astype(np.uint8)


def kernel_to_image(k: np.ndarray) -> np.ndarray:
    """Kernel ``[Nk, Nl]`` → uint8 centered at 128 with ×100 gain
    (reference: ``SpinToImage_K`` netlib.cpp:97-111, including its
    sign-fold quirk ``128 - intens`` for negatives)."""
    intens = (100 * k.T).astype(np.int64)
    out = np.where(intens > 0, intens + 128, 128 - intens)
    return out.astype(np.uint8)


# -------------------------------------------------------------- frame sources

def synthetic_frames(nx: int, ny: int, *,
                     seed: int = 0) -> Iterator[np.ndarray]:
    """Deterministic synthetic video: smooth drifting pattern, camera-like.

    Stands in for the live camera in tests/benchmarks; uint8 HWC frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, size=3)
    freq = rng.uniform(0.02, 0.1, size=(3, 2))
    t = 0
    while True:
        chans = []
        for c in range(3):
            z = 127.5 + 127.5 * np.sin(
                freq[c, 0] * xx + freq[c, 1] * yy + phase[c] + 0.1 * t)
            chans.append(z)
        yield np.stack(chans, axis=-1).astype(np.uint8)
        t += 1


def npy_video(path: str) -> Iterator[np.ndarray]:
    """Frames from a ``.npy``/``.npz`` array of shape [T, H, W, 3] uint8."""
    arr = np.load(path)
    if hasattr(arr, "files"):
        arr = arr[arr.files[0]]
    for frame in arr:
        yield np.asarray(frame, dtype=np.uint8)


def y4m_video(path: str) -> Iterator[np.ndarray]:
    """Frames from a YUV4MPEG2 (``.y4m``) file — pure-Python, no OpenCV.

    Supports C420/C422/C444 colorspaces (nearest-neighbor chroma
    upsampling) and yields uint8 BGR HWC frames via the BT.601
    limited-range transform, so real video files feed the pipeline on rigs
    without cv2 (the reference requires OpenCV for any file input).
    """
    with open(path, "rb") as fh:
        header = fh.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"{path}: not a YUV4MPEG2 stream")
        w = h = None
        cs = "420"
        for tok in header.split()[1:]:
            if tok[0] == "W":
                w = int(tok[1:])
            elif tok[0] == "H":
                h = int(tok[1:])
            elif tok[0] == "C":
                cs = tok[1:4]
        if not w or not h:
            raise ValueError(f"{path}: missing W/H in header {header!r}")
        sub = {"420": 2, "422": (1, 2), "444": 1}.get(cs)
        if sub is None:
            raise ValueError(f"{path}: unsupported colorspace C{cs}")
        sy, sx = (1, 2) if cs == "422" else (sub, sub)
        cw, ch = w // sx, h // sy
        while True:
            line = fh.readline()
            if not line:
                return
            if not line.startswith(b"FRAME"):
                raise ValueError(f"{path}: bad frame marker {line[:16]!r}")
            raw = fh.read(w * h + 2 * cw * ch)
            if len(raw) < w * h + 2 * cw * ch:
                return
            y = np.frombuffer(raw, np.uint8, w * h).reshape(h, w)
            u = np.frombuffer(raw, np.uint8, cw * ch, w * h).reshape(ch, cw)
            v = np.frombuffer(raw, np.uint8, cw * ch,
                              w * h + cw * ch).reshape(ch, cw)
            if _native.has_yuv():
                # threaded C++ colorspace stage (native/host_runtime.cpp)
                yield _native.yuv_to_bgr(y, u, v, sy, sx)
                continue
            if (sy, sx) != (1, 1):
                # clamped index map, matching the native path's
                # ci = min(i/sx, cw-1) — plain repeat-and-crop comes up a
                # column/row short when w or h is odd (cw·sx < w)
                ri = np.minimum(np.arange(h) // sy, ch - 1)
                ci = np.minimum(np.arange(w) // sx, cw - 1)
                u = u[ri][:, ci]
                v = v[ri][:, ci]
            yf = 1.164 * (y.astype(np.float32) - 16.0)
            uf = u.astype(np.float32) - 128.0
            vf = v.astype(np.float32) - 128.0
            r = yf + 1.596 * vf
            g = yf - 0.813 * vf - 0.391 * uf
            b = yf + 2.018 * uf
            bgr = np.stack([b, g, r], axis=-1)
            yield np.clip(np.round(bgr), 0, 255).astype(np.uint8)


def image_dir_frames(path: str, *, loop: bool = False,
                     channel_order: str = "rgb") -> Iterator[np.ndarray]:
    """Frames from a directory of ``.png`` images (sorted by name) — a
    dataset source the reference lacks (camera only).  Decoded by the
    dependency-free reader in :mod:`spectralae_torch.viz.png` (all filter
    types; C unfilter when the native lib is built).  Grayscale images
    are broadcast to 3 channels.  The pipeline's frame convention is BGR
    (camera/y4m yield BGR), while PNG stores RGB: ``channel_order="rgb"``
    (default) treats the files as standard RGB and reverses to BGR;
    ``"bgr"`` passes channels through unchanged — use it for PNGs written
    by this framework's own viz dumps, which store pipeline order as-is.
    ``loop=True`` cycles the directory forever (epoch training).
    """
    from pathlib import Path as _P

    from ..viz.png import read_png
    if channel_order not in ("rgb", "bgr"):
        raise ValueError(f"channel_order must be 'rgb' or 'bgr', "
                         f"got {channel_order!r}")
    files = sorted(_P(path).glob("*.png"))
    if not files:
        raise ValueError(f"{path}: no .png files")
    while True:
        for f in files:
            img = read_png(f)
            if img.ndim == 2:
                img = np.repeat(img[:, :, None], 3, axis=2)
            elif channel_order == "rgb":
                img = img[:, :, ::-1]
            yield img
        if not loop:
            return


def camera_frames(index: int = 0) -> Iterator[np.ndarray]:
    """Live camera via OpenCV when available (reference A2)."""
    try:
        import cv2
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "camera source requires opencv-python; use synthetic_frames or "
            "npy_video instead") from e
    cam = cv2.VideoCapture(index)
    while True:
        ok, frame = cam.read()
        if not ok:
            break
        yield frame


def video_file_frames(path: str, *, loop: bool = False
                      ) -> Iterator[np.ndarray]:
    """Frames from any container/codec OpenCV can demux (mp4/avi/mkv/…) —
    BGR uint8 HWC, like the camera.  The reference can only consume the
    camera; ``.y4m`` remains the cv2-free fallback (:func:`y4m_video`).
    ``loop=True`` rewinds at EOF (epoch training)."""
    try:
        import cv2
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            f"reading {path} requires opencv-python; convert to .y4m "
            "(ffmpeg -i in.mp4 out.y4m) for the cv2-free path") from e
    while True:
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise ValueError(f"OpenCV cannot open {path}")
        got_any = False
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            got_any = True
            yield frame
        cap.release()
        if not (loop and got_any):
            return


def resize_nn(img: np.ndarray, nx: int, ny: int) -> np.ndarray:
    """Nearest-neighbor resize of an HWC frame to (ny, nx) — stands in for
    the reference's cv::resize (autoencoder.cpp:124).  Dispatches to the
    native stage (same index math, host_runtime.cpp:62-73) when built."""
    if (_native.available() and img.ndim == 3
            and img.shape[2] == 3 and img.dtype == np.uint8):
        return _native.resize_nn(img, nx, ny)
    h, w = img.shape[:2]
    ri = (np.arange(ny) * h // ny)
    ci = (np.arange(nx) * w // nx)
    return img[ri][:, ci]


# ----------------------------------------------------------------- prefetcher

class DevicePrefetcher:
    """Double-buffered host→device pipeline.

    A worker thread pulls frames, converts and batches them, and copies the
    next batch to ``device`` while the device computes on the current one.
    On a CUDA device the copy comes from pinned host memory, runs on the
    prefetcher's own stream, and records an event; :meth:`__next__` makes
    the consumer's current stream wait on that event before handing the
    batch out, so no kernel reads a batch before its copy has landed.
    """

    def __init__(self, source: Iterator[np.ndarray], nx: int, ny: int,
                 batch: int = 1, depth: int = 2, *,
                 device: torch.device | str = "cuda"):
        self._source = source
        self._nx, self._ny, self._batch = nx, ny, batch
        self._device = torch.device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _make_batch(self) -> np.ndarray | None:
        frames = []
        for _ in range(self._batch):
            try:
                f = next(self._source)
            except StopIteration:
                break
            frames.append(f)
        if not frames:
            return None
        # a finite source's trailing partial batch is yielded, not dropped
        if (_native.has_batch() and len(frames) > 1
                and all(f.shape == frames[0].shape and f.dtype == np.uint8
                        for f in frames)):
            # fused threaded resize+convert stage (C++, one thread/frame)
            return _native.batch_to_tensor(np.stack(frames),
                                           self._nx, self._ny)
        return np.stack([
            frame_to_tensor(resize_nn(f, self._nx, self._ny))
            for f in frames])

    def _to_device(self, batch: np.ndarray):
        host = torch.from_numpy(batch)
        if self._stream is None:
            return host.to(self._device), None
        with torch.cuda.stream(self._stream):
            dev = host.pin_memory().to(self._device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return dev, ready

    def _work(self):
        try:
            while not self._stop.is_set():
                batch = self._make_batch()
                if batch is None:
                    self._q.put(None)
                    return
                self._q.put(self._to_device(batch))
        except BaseException as e:  # propagate to the consumer — a dead
            # worker must not leave __next__ blocked forever
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        # the worker enqueues its None/exception sentinel exactly once and
        # exits; without the terminal flag, a next() call after exhaustion
        # (or after the propagated error was raised) would block forever
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        dev, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            # the batch was allocated on the copy stream: tell the caching
            # allocator it is now in use on the consumer's stream too
            dev.record_stream(consumer)
        return dev

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
