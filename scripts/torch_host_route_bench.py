#!/usr/bin/env python3
"""Host codec routes of the port's frame pipeline: numpy against the C++
native library (``native/host_runtime.cpp``, built by this script with
``make`` into a temporary directory).

``spectralae_torch.data.pipeline`` takes the native library for its
conversions when the library is built, and numpy otherwise.  This script
times both routes, within one process on one card, at the sizes the
CLI's paths give them:

- the frame source: 8 frames of the CLI's default synthetic source at
  256^2 (both routes share it);
- the prefetcher's batch stage (``DevicePrefetcher._make_batch``): 8
  camera-sized frames (480x640 uint8 BGR) resized to 256^2 and converted
  to a float32 [8, 3, 256, 256] batch;
- the prefetcher's batches per second to the card, over the same frames;
- the conversions of one ``run`` frame, each alone (``resize_nn`` of a
  camera-sized frame to 256^2, ``frame_to_tensor`` of the result,
  ``tensor_to_frame`` of the reconstruction) and the
  whole frame with ``Engine.step`` on the default 3-pair net at 256^2
  (fft inference, the reconstruction back on the host);
- the file sources' decoders: 8 camera-sized frames of a 4:2:0 ``.y4m``
  file (the YUV to BGR stage), and one camera-sized RGB PNG whose rows
  all carry the Paeth filter (the scanline unfilter).

The routes are taken in turns (numpy, native, native, numpy, ...); their
outputs are compared bit for bit first.  Prints the card's name and power
limit, one line a reading, then one JSON line with the medians::

    python scripts/torch_host_route_bench.py
"""

from __future__ import annotations

import itertools
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NX, BATCH, ROUNDS = 256, 8, 4
CAMERA = (480, 640)
# the pipeline with the native library reported absent
NUMPY = types.SimpleNamespace(available=lambda: False,
                              has_batch=lambda: False,
                              has_yuv=lambda: False)


def write_sources(tmp: Path, rng) -> tuple[Path, Path]:
    """A 4:2:0 ``.y4m`` file of 8 camera-sized frames and a camera-sized
    RGB PNG whose rows all carry filter 4 (Paeth), random bytes."""
    import zlib
    from spectralae_torch.viz.png import _chunk
    h, w = CAMERA
    y4m = tmp / "camera.y4m"
    with open(y4m, "wb") as fh:
        fh.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420\n".encode())
        for _ in range(BATCH):
            fh.write(b"FRAME\n" + rng.integers(
                0, 256, size=w * h * 3 // 2, dtype=np.uint8).tobytes())
    rows = rng.integers(0, 256, size=(h, 3 * w), dtype=np.uint8)
    raw = b"".join(b"\x04" + row.tobytes() for row in rows)
    png = tmp / "paeth.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2, 0, 0, 0)) + _chunk(
            b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
    return y4m, png


def host_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    build = Path(tempfile.mkdtemp())
    subprocess.run(["make", "-C", str(ROOT / "native"), f"BUILD={build}"],
                   check=True, capture_output=True)
    lib = build / "libspectralae_host.so"
    os.environ["SPECTRALAE_NATIVE_LIB"] = str(lib)
    from spectralae_torch.core.config import Config
    from spectralae_torch.data import native, pipeline
    from spectralae_torch.model.engine import Engine
    if not (native.available() and native._lib._name == str(lib)
            and native.has_batch()):
        print("the native library did not load", file=sys.stderr)
        return 1
    from spectralae_torch.viz import png as png_mod
    routes = {"numpy": NUMPY, "native": native}
    has_unfilter = native.has_png_unfilter

    def take(name):
        """The pipeline's and the PNG reader's route."""
        pipeline._native = routes[name]
        native.has_png_unfilter = (has_unfilter if name == "native"
                                   else lambda: False)
    rng = np.random.default_rng(0)
    camera = [rng.integers(0, 256, size=CAMERA + (3,), dtype=np.uint8)
              for _ in range(2 * BATCH)]

    y4m, png = write_sources(build, rng)

    def decode_y4m():
        return np.stack(list(pipeline.y4m_video(str(y4m))))

    def read_png():
        return png_mod.read_png(png)

    def batch_stage():
        src = types.SimpleNamespace(_source=iter(camera[:BATCH]), _nx=NX,
                                    _ny=NX, _batch=BATCH)
        return pipeline.DevicePrefetcher._make_batch(src)

    def prefetch(n=32):
        pf = pipeline.DevicePrefetcher(itertools.cycle(camera), NX, NX,
                                       batch=BATCH, device="cuda")
        for _ in range(n):
            next(pf)
        pf.close()

    eng = Engine(Config(nx=NX, ny=NX), seed=0, device="cuda")
    eng.add_layer()
    eng.add_layer()
    out = eng.step(pipeline.frame_to_tensor(
        pipeline.resize_nn(camera[0], NX, NX)))

    small = pipeline.resize_nn(camera[1], NX, NX)

    def run_frame():
        x = pipeline.frame_to_tensor(pipeline.resize_nn(camera[1], NX, NX))
        pipeline.tensor_to_frame(eng.step(x))

    got = {}
    for name in routes:
        take(name)
        got[name] = (batch_stage(), pipeline.frame_to_tensor(camera[0]),
                     pipeline.resize_nn(camera[0], NX, NX),
                     pipeline.tensor_to_frame(out), decode_y4m(), read_png())
    for a, b in zip(*got.values()):
        if not np.array_equal(a, b):
            print("the routes disagree", file=sys.stderr)
            return 1
    synth = pipeline.synthetic_frames(NX, NX, seed=0)
    source_ms = host_ms(lambda: list(itertools.islice(synth, BATCH)), 10)
    print(f"synthetic source, {BATCH} frames {NX}x{NX}: {source_ms:.4f} ms "
          "host", flush=True)
    stages = {"batch_stage_ms": (batch_stage, 20),
              "prefetch_batch_ms": (prefetch, 1),
              "resize_ms": (lambda: pipeline.resize_nn(camera[1], NX, NX),
                            50),
              "to_tensor_ms": (lambda: pipeline.frame_to_tensor(small), 50),
              "to_frame_ms": (lambda: pipeline.tensor_to_frame(out), 50),
              "run_frame_ms": (run_frame, 20),
              "y4m_decode_ms": (decode_y4m, 3),
              "png_read_ms": (read_png, 1)}
    medians = {}
    for stage, (fn, reps) in stages.items():
        ms = {name: [] for name in routes}
        for k in range(ROUNDS):
            for name in (list(routes) if k % 2 == 0 else list(routes)[::-1]):
                take(name)
                per = 32 if fn is prefetch else 1
                ms[name].append(host_ms(fn, reps) / per)
        medians[stage] = {name: float(np.median(v)) for name, v in ms.items()}
        print(f"{stage}: " + "; ".join(
            f"{name} {[round(v, 4) for v in vals]} median "
            f"{medians[stage][name]:.4f} ms" for name, vals in ms.items()),
              flush=True)
    take("native")
    print(json.dumps({"card": card, "nx": NX, "batch": BATCH,
                      "camera": list(CAMERA),
                      "synthetic_source_ms": source_ms, **medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
