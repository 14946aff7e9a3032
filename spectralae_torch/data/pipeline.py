"""Host input pipeline: codecs, synthetic frames and device prefetch.

Port of the serving subset of :mod:`spectralae.data.pipeline`: the numpy
codecs, the synthetic source, nearest-neighbour resize, and a prefetcher
that copies each batch to the device from pinned host memory on its own
CUDA stream while the device computes on the previous one.  The C++ native
codec binding and the file/camera sources wait for ROADMAP A13.

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


def resize_nn(img: np.ndarray, nx: int, ny: int) -> np.ndarray:
    """Nearest-neighbor resize of an HWC frame to (ny, nx) — stands in for
    the reference's cv::resize (autoencoder.cpp:124)."""
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
