"""Minimal dependency-free PNG writer and reader (stdlib zlib only).

A copy of :mod:`spectralae.viz.png` (framework-free).  Replaces the
reference's four OpenCV ``imshow`` windows (source/autoencoder.cpp:211-242)
with image dumps usable headlessly, and reads PNG datasets back.
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


def _unfilter_py(raw: bytes, h: int, wb: int, ch: int) -> np.ndarray:
    """Pure-Python PNG scanline unfilter (RFC 2083 filters 0-4) — the
    fallback when the C implementation (native/host_runtime.cpp::
    sae_png_unfilter) isn't built.  sub/average/paeth are sequential per
    byte, so this is slow on large frames; correctness-identical."""
    out = np.zeros((h, wb), np.uint8)
    stride = wb + 1
    for r in range(h):
        ft = raw[r * stride]
        src = np.frombuffer(raw, np.uint8, wb, r * stride + 1)
        if ft == 0:
            out[r] = src
        elif ft == 2:
            out[r] = src + (out[r - 1] if r else 0)
        elif ft == 1:
            row = out[r]
            row[:ch] = src[:ch]
            for i in range(ch, wb):
                row[i] = (int(src[i]) + int(row[i - ch])) & 0xFF
        elif ft in (3, 4):
            row = out[r]
            up = out[r - 1] if r else np.zeros((wb,), np.uint8)
            for i in range(wb):
                a = int(row[i - ch]) if i >= ch else 0
                b = int(up[i])
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(up[i - ch]) if (r and i >= ch) else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                row[i] = (int(src[i]) + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter type {ft}")
    return out


def read_png(path: str | Path) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG: grayscale ``[H, W]``, RGB
    ``[H, W, 3]``, or RGBA (alpha dropped) — all five scanline filters
    supported (C fast path when the native lib is built)."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = color_type = bits = interlace = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bits, color_type, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", payload[:13])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    if bits != 8 or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs "
                         f"(bits={bits}, interlace={interlace})")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type)
    if channels is None:
        raise ValueError(f"{path}: unsupported color type {color_type}")
    raw = zlib.decompress(idat)
    wb = w * channels
    from ..data import native
    if native.has_png_unfilter():
        img = native.png_unfilter(raw, h, wb, channels)
    else:
        img = _unfilter_py(raw, h, wb, channels)
    img = img.reshape(h, w, channels)
    if channels == 1:
        return img[..., 0]
    if channels == 2:   # gray+alpha → gray
        return img[..., 0]
    if channels == 4:   # drop alpha
        return np.ascontiguousarray(img[..., :3])
    return img
