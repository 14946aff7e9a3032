"""Minimal dependency-free PNG writer (stdlib zlib only).

The writer half of :mod:`spectralae.viz.png`, copied (it is framework-free);
the reader waits for ROADMAP A13.  Replaces the reference's four OpenCV
``imshow`` windows (source/autoencoder.cpp:211-242) with image dumps usable
headlessly.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str | Path, img: np.ndarray) -> None:
    """Write a uint8 grayscale ``[H, W]`` or color ``[H, W, 3]`` PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if img.ndim == 2:
        color_type, channels = 0, 1
        h, w = img.shape
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, channels = 2, 3
        h, w = img.shape[:2]
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    raw = b"".join(
        b"\x00" + img[r].tobytes() for r in range(h))
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", header)
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    Path(path).write_bytes(png)
