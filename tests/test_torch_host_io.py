"""The port's host modules against the JAX package's on the same files.

Host code on numpy arrays, so every comparison is exact: the frame sources
(``.npy``/``.npz``, ``.y4m`` in three chroma layouts, a PNG directory in
both channel orders; the camera and OpenCV video sources on a stubbed
``cv2``), the codecs and ``kernel_to_image``, ``read_png`` on every scanline
filter (C and Python unfilter), the spectrum images and the ANSI renderer.
The native binding is held against JAX's binding of the same library and
against the numpy paths where the library builds (``make -C native``, into
a directory of this test session's own, so that no other test process
loads a library while it is written), and skips with its reason where it
does not.
"""

import ctypes
import itertools
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from spectralae.data import native as jnative
from spectralae.data import pipeline as jpipe
from spectralae.viz import ansi as jansi
from spectralae.viz import png as jpng
from spectralae.viz import spectrum as jspectrum
from spectralae_torch.data import native as tnative
from spectralae_torch.data import pipeline as tpipe
from spectralae_torch.viz import ansi as tansi
from spectralae_torch.viz import png as tpng
from spectralae_torch.viz import spectrum as tspectrum

ROOT = Path(__file__).resolve().parents[1]
# the port's pipeline with the native library reported absent
NO_NATIVE = types.SimpleNamespace(available=lambda: False,
                                  has_batch=lambda: False,
                                  has_yuv=lambda: False,
                                  has_png_unfilter=lambda: False)


@pytest.fixture(scope="module")
def native_so(tmp_path_factory):
    out = tmp_path_factory.mktemp("native")
    r = subprocess.run(["make", "-C", str(ROOT / "native"), f"BUILD={out}"],
                       capture_output=True)
    if r.returncode != 0:
        pytest.skip("native toolchain unavailable")
    return out / "libspectralae_host.so"


@pytest.fixture
def native(monkeypatch, native_so):
    """Both packages' bindings on one freshly built library."""
    for mod in (tnative, jnative):
        lib = ctypes.CDLL(str(native_so))
        mod._bind(lib)
        monkeypatch.setattr(mod, "_lib", lib)
    return tnative


def _same_frames(a, b, n=None):
    a = list(itertools.islice(a, n)) if n else list(a)
    b = list(itertools.islice(b, n)) if n else list(b)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.uint8
        np.testing.assert_array_equal(x, y)
    return a


def _write_y4m(path, frames_yuv, w, h, cs="420"):
    with open(path, "wb") as fh:
        fh.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C{cs}\n".encode())
        for y, u, v in frames_yuv:
            fh.write(b"FRAME\n")
            fh.write(y.tobytes() + u.tobytes() + v.tobytes())


@pytest.mark.parametrize("suffix", [".npy", ".npz"])
def test_npy_video_matches_jax(tmp_path, suffix):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, size=(4, 12, 10, 3), dtype=np.uint8)
    path = tmp_path / f"v{suffix}"
    if suffix == ".npy":
        np.save(path, arr)
    else:
        np.savez(path, frames=arr)
    got = _same_frames(tpipe.npy_video(str(path)),
                       jpipe.npy_video(str(path)))
    np.testing.assert_array_equal(got[2], arr[2])


@pytest.mark.parametrize("cs,sub,w,h", [("420", (2, 2), 16, 12),
                                        ("422", (1, 2), 7, 5),
                                        ("444", (1, 1), 6, 4)])
@pytest.mark.parametrize("use_native", [False, True],
                         ids=["numpy", "native"])
def test_y4m_video_matches_jax(tmp_path, monkeypatch, request, cs, sub, w,
                               h, use_native):
    if use_native:
        request.getfixturevalue("native")
    else:
        monkeypatch.setattr(tpipe, "_native", NO_NATIVE)
        monkeypatch.setattr(jpipe, "_native", None)
    rng = np.random.default_rng(1)
    sy, sx = sub
    frames = [(rng.integers(0, 256, size=(h, w), dtype=np.uint8),
               rng.integers(0, 256, size=(h // sy, w // sx), dtype=np.uint8),
               rng.integers(0, 256, size=(h // sy, w // sx), dtype=np.uint8))
              for _ in range(3)]
    p = tmp_path / f"v{cs}.y4m"
    _write_y4m(p, frames, w, h, cs)
    got = _same_frames(tpipe.y4m_video(str(p)), jpipe.y4m_video(str(p)))
    assert got[0].shape == (h, w, 3)


def test_y4m_video_rejects_garbage(tmp_path):
    p = tmp_path / "bad.y4m"
    p.write_bytes(b"MPEG nope\n")
    with pytest.raises(ValueError, match="not a YUV4MPEG2"):
        next(tpipe.y4m_video(str(p)))


@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_image_dir_frames_match_jax(tmp_path, order):
    rng = np.random.default_rng(12)
    for i in range(3):
        tpng.write_png(tmp_path / f"frame_{i:03d}.png",
                       rng.integers(0, 256, size=(20, 18, 3),
                                    dtype=np.uint8))
    tpng.write_png(tmp_path / "frame_003.png",
                   rng.integers(0, 256, size=(20, 18), dtype=np.uint8))
    got = _same_frames(
        tpipe.image_dir_frames(str(tmp_path), channel_order=order),
        jpipe.image_dir_frames(str(tmp_path), channel_order=order))
    assert len(got) == 4 and got[3].shape == (20, 18, 3)
    looped = tpipe.image_dir_frames(str(tmp_path), loop=True)
    assert len(list(itertools.islice(looped, 9))) == 9
    with pytest.raises(ValueError, match="channel_order"):
        next(tpipe.image_dir_frames(str(tmp_path), channel_order="rbg"))
    with pytest.raises(ValueError, match="no .png"):
        next(tpipe.image_dir_frames(str(tmp_path / "none")))


def _encode_png_with_filters(img, filters):
    """A PNG whose row r uses filters[r % len]: read_png must reverse
    sub/up/average/paeth (tests/test_io_data.py's encoder)."""
    import struct
    import zlib
    h, w, ch = img.shape
    raw = bytearray()
    prev = np.zeros((w * ch,), np.int32)
    flat = img.reshape(h, w * ch).astype(np.int32)
    for r in range(h):
        ft = filters[r % len(filters)]
        row = flat[r]
        enc = np.zeros((w * ch,), np.int32)
        for i in range(w * ch):
            a = row[i - ch] if i >= ch else 0
            b = prev[i]
            c = prev[i - ch] if (r and i >= ch) else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b if r else 0
            elif ft == 3:
                pred = (a + (b if r else 0)) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else \
                    (b if pb <= pc else c)
            enc[i] = (row[i] - pred) & 0xFF
        raw.append(ft)
        raw.extend(enc.astype(np.uint8).tobytes())
        prev = row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("unfilter", ["native", "python"])
def test_read_png_every_filter_matches_jax(tmp_path, monkeypatch, request,
                                           unfilter):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, size=(10, 7, 3), dtype=np.uint8)
    p = tmp_path / "f.png"
    p.write_bytes(_encode_png_with_filters(img, [0, 1, 2, 3, 4]))
    if unfilter == "python":
        monkeypatch.setattr(tnative, "has_png_unfilter", lambda: False)
    else:
        assert request.getfixturevalue("native").has_png_unfilter()
    got = tpng.read_png(p)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jpng.read_png(p))


def test_png_roundtrip_and_refusals(tmp_path):
    gray = np.arange(48, dtype=np.uint8).reshape(6, 8)
    tpng.write_png(tmp_path / "g.png", gray)
    np.testing.assert_array_equal(tpng.read_png(tmp_path / "g.png"), gray)
    assert (tmp_path / "g.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        tpng.read_png(tmp_path / "x.png")


def test_codecs_and_kernel_image_match_jax():
    rng = np.random.default_rng(5)
    k = rng.normal(0, 2, size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpipe.kernel_to_image(k),
                                  jpipe.kernel_to_image(k))
    assert tpipe.kernel_to_image(k).shape == (3, 5)
    img = rng.integers(0, 256, (20, 12, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tpipe.frame_to_tensor(img),
                                  jpipe.frame_to_tensor(img))
    np.testing.assert_array_equal(tpipe.resize_nn(img, 7, 9),
                                  jpipe.resize_nn(img, 7, 9))


def test_camera_frames_with_stubbed_videocapture(monkeypatch):
    frames = [np.full((6, 8, 3), i, np.uint8) for i in range(3)]

    class FakeCapture:
        def __init__(self, index):
            assert index == 0
            self._i = 0

        def read(self):
            if self._i >= len(frames):
                return False, None
            self._i += 1
            return True, frames[self._i - 1]

    fake_cv2 = types.ModuleType("cv2")
    fake_cv2.VideoCapture = FakeCapture
    monkeypatch.setitem(sys.modules, "cv2", fake_cv2)
    got = list(tpipe.camera_frames())
    assert len(got) == 3
    np.testing.assert_array_equal(got[1], frames[1])


def test_video_file_frames_with_stubbed_cv2(monkeypatch):
    frames = [np.full((4, 5, 3), 10 * i, np.uint8) for i in range(3)]

    class FakeCapture:
        def __init__(self, path):
            self._ok = path != "missing.mp4"
            self._i = 0

        def isOpened(self):
            return self._ok

        def read(self):
            if self._i >= len(frames):
                return False, None
            self._i += 1
            return True, frames[self._i - 1]

        def release(self):
            pass

    fake_cv2 = types.ModuleType("cv2")
    fake_cv2.VideoCapture = FakeCapture
    monkeypatch.setitem(sys.modules, "cv2", fake_cv2)
    assert len(list(tpipe.video_file_frames("v.mp4"))) == 3
    looped = tpipe.video_file_frames("v.mp4", loop=True)
    assert len(list(itertools.islice(looped, 7))) == 7
    with pytest.raises(ValueError, match="cannot open"):
        next(tpipe.video_file_frames("missing.mp4"))


@pytest.mark.parametrize("source", ["camera", "video"])
def test_opencv_sources_raise_without_cv2(monkeypatch, source):
    import builtins
    monkeypatch.delitem(sys.modules, "cv2", raising=False)
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("No module named cv2")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    it = (tpipe.camera_frames() if source == "camera"
          else tpipe.video_file_frames("v.mp4"))
    with pytest.raises(RuntimeError, match="opencv-python"):
        next(it)


def test_spectrum_image_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 10)).astype(np.float32)
    spec = np.fft.rfft2(x)
    for a, b in ((tspectrum.magnitude(spec, 8, 10),
                  jspectrum.magnitude(spec, 8, 10)),
                 (tspectrum.shift_magnitude(np.abs(x)),
                  jspectrum.shift_magnitude(np.abs(x))),
                 (tspectrum.spectrum_image(np.abs(spec[0]), 8, 10),
                  jspectrum.spectrum_image(np.abs(spec[0]), 8, 10))):
        np.testing.assert_array_equal(a, b)
    full = np.abs(np.fft.fft2(x))
    np.testing.assert_allclose(tspectrum.magnitude(spec, 8, 10),
                               np.sqrt(full / x.size), rtol=1e-5, atol=1e-6)


def test_ansi_renderer_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(9, 7, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, size=(4, 4), dtype=np.uint8)
    assert tansi.render_image(img) == jansi.render_image(img)
    assert "\x1b[38;2;" in tansi.render_image(gray)
    views = {"input": img, "output": img, "feature_map": gray,
             "kernel": gray[:2]}
    dash = tansi.render_dashboard(views, "status line")
    assert dash == jansi.render_dashboard(views, "status line")
    assert dash.startswith("status line")


def test_native_binding_resolves_the_same_library():
    """Both bindings look for native/build/libspectralae_host.so at the
    root of the checkout, the port's from its own path."""
    src = Path(tnative.__file__).read_text()
    assert "parents[2]" in src and '"native" / "build"' in src
    assert (Path(tnative.__file__).resolve().parents[2]
            == Path(jnative.__file__).resolve().parents[2] == ROOT)


def test_native_codecs_match_jax_and_numpy(native):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(20, 24, 3), dtype=np.uint8)
    got = native.frame_to_tensor(img)
    np.testing.assert_array_equal(got, jnative.frame_to_tensor(img))
    np.testing.assert_array_equal(got,
                                  img.astype(np.float32).transpose(2, 1, 0))
    spin = rng.normal(128, 90, size=(3, 24, 20)).astype(np.float32)
    np.testing.assert_array_equal(
        native.tensor_to_frame(spin),
        np.clip(np.round(spin.transpose(2, 1, 0)), 0, 255).astype(np.uint8))
    h, w = img.shape[:2]
    ri, ci = np.arange(10) * h // 10, np.arange(12) * w // 12
    np.testing.assert_array_equal(native.resize_nn(img, 12, 10),
                                  img[ri][:, ci])
    with pytest.raises(ValueError, match="expects"):
        native.frame_to_tensor(img[..., 0])


def test_prefetcher_native_batch_stage_matches_the_numpy_path(native):
    assert native.has_batch()
    pf = tpipe.DevicePrefetcher(tpipe.synthetic_frames(40, 40, seed=3),
                                16, 16, batch=4, device="cpu")
    batch = next(pf)
    pf.close()
    src = tpipe.synthetic_frames(40, 40, seed=3)
    want = np.stack([tpipe.frame_to_tensor(tpipe.resize_nn(next(src), 16,
                                                           16))
                     for _ in range(4)])
    np.testing.assert_array_equal(batch.numpy(), want)
    imgs = np.stack([next(src) for _ in range(3)])
    np.testing.assert_array_equal(native.batch_to_tensor(imgs, 16, 12),
                                  jnative.batch_to_tensor(imgs, 16, 12))
