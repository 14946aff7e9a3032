"""The port's ``run`` and ``eval`` commands, ``train --mode stream --domain
coord`` and ``--source`` for train/serve/eval, on the CPU.

- ``run`` with scripted keys writes the view PNGs and an ``mse:`` line per
  trained frame; ``--tui`` and ``--gui`` drive the engine through a stubbed
  key reader and a stubbed ``cv2``; without ``--device cpu`` and without a
  GPU it exits with its reason.
- ``eval`` of one checkpoint equals the JAX CLI's ``eval`` JSON: frames
  equal, ``mse_per_pixel`` and ``psnr_db`` at 1e-5 relative (float32
  forwards through two libraries; the squared error summed in float64).
- ``train --mode stream --domain coord`` resumed from one checkpoint logs
  the JAX CLI's records (steps, pairs) with each mse at 1e-5 and ends at
  its weights at 1e-5 (six frames of float32 convolutions).
- ``train``, ``serve``, ``eval`` and ``run`` read a ``.npy`` stack, a
  ``.y4m`` video and a PNG directory.
"""

import io
import json
import sys
import types

import numpy as np
import pytest
import torch

from spectralae_torch.cli.main import main as tcli
from spectralae_torch.io import checkpoint as tckpt

torch.set_num_threads(1)

TOL = 1e-5


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _records(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_run_with_scripted_keys_dumps_views(tmp_path, capsys):
    tcli(["run", "--nx", "32", "--layers", "2", "--frames", "6", "--keys",
          "1f1g", "--device", "cpu", "--dump-every", "2", "--outdir",
          str(tmp_path)])
    out = capsys.readouterr().out
    assert "key '1' -> True" in out and "key 'f' -> False" in out
    mse_frames = [int(line.split()[1].rstrip(":"))
                  for line in out.splitlines() if " mse: " in line]
    # the fft burst at frame 1 disarms; coord training from frame 3 on
    assert mse_frames == [1, 2, 3, 4, 5]
    for i in (0, 2, 4):
        for view in ("input", "output", "feature_map", "kernel"):
            assert (tmp_path / f"{view}_{i:05d}.png").exists()
    assert not (tmp_path / "layer_0_00004.png").exists()   # 'g': fft only


def test_run_fft_layer_views_are_dumped(tmp_path, capsys):
    tcli(["run", "--nx", "16", "--frames", "2", "--keys", "g", "--device",
          "cpu", "--dump-every", "1", "--outdir", str(tmp_path)])
    capsys.readouterr()
    assert (tmp_path / "spectrum_00001.png").exists()
    assert (tmp_path / "layer_4_00001.png").exists()


def test_run_without_a_gpu_exits_and_does_not_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli(["run", "--nx", "16", "--frames", "1"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli(["eval", "--nx", "16", "--steps", "1"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli(["serve", "--model", "nowhere"])


def test_run_interactive_reads_keys_from_stdin(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("i\n1\nQ\n"))
    tcli(["run", "--nx", "16", "--frames", "5", "--interactive", "--device",
          "cpu", "--outdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "Network structure" in out and "key '1' -> True" in out
    assert "frame 2" in out and "frame 3" not in out     # 'Q' quit


def test_run_tui_with_stubbed_key_reader(monkeypatch):
    """The TUI loop on the port's engine: fake termios and keys."""
    from spectralae_torch.cli import tui
    from spectralae_torch.data import pipeline
    from spectralae_torch.model.engine import Engine
    from spectralae_torch.core.config import Config
    eng = Engine(Config(nx=16, ny=16, fft_iters=5), device="cpu")
    keys = iter(["1", None, "\x1b"])
    monkeypatch.setattr(tui, "_read_key", lambda timeout=0.0: next(keys))
    monkeypatch.setitem(sys.modules, "termios", types.SimpleNamespace(
        tcgetattr=lambda fd: None, tcsetattr=lambda fd, how, attrs: None,
        TCSADRAIN=0))
    monkeypatch.setitem(sys.modules, "tty",
                        types.SimpleNamespace(setcbreak=lambda fd: None))
    out = io.StringIO()
    tui.run_tui(eng, pipeline.synthetic_frames(16, 16), nx=16, ny=16,
                frames=10, out=out)
    text = out.getvalue()
    assert "frame 0" in text and "frame 2" in text
    assert "frame 3" not in text          # Esc on the third frame quit
    assert "mse nan" in text.split("frame 1")[0]
    assert "mse nan" not in text.split("frame 1")[1]


def test_run_tui_through_the_cli(monkeypatch, capsys):
    from spectralae_torch.cli import tui
    seen = {}

    def fake_tui(eng, src, *, nx, ny, frames):
        seen.update(nx=nx, ny=ny, frames=frames, device=str(eng.device))
    monkeypatch.setattr(tui, "run_tui", fake_tui)
    tcli(["run", "--nx", "16", "--frames", "3", "--tui", "--device", "cpu"])
    assert seen == {"nx": 16, "ny": 16, "frames": 3, "device": "cpu"}


class _FakeCV2(types.ModuleType):
    WINDOW_NORMAL = 0

    class error(Exception):
        pass

    def __init__(self, keys, fail_windows=False):
        super().__init__("cv2")
        self._keys = list(keys)
        self._fail_windows = fail_windows
        self.named, self.shown, self.destroyed = [], [], False

    def namedWindow(self, name, flags=0):
        if self._fail_windows:
            raise self.error("no display")
        self.named.append(name)

    def moveWindow(self, name, x, y):
        pass

    def resizeWindow(self, name, w, h):
        pass

    def imshow(self, name, img):
        self.shown.append((name, img.shape))

    def waitKey(self, ms=0):
        return self._keys.pop(0) if self._keys else -1

    def destroyAllWindows(self):
        self.destroyed = True


def test_run_gui_with_stubbed_cv2(monkeypatch, capsys):
    """The four reference windows and waitKey dispatch
    (autoencoder.cpp:55-66, 211-246); a keycode with high bits set is
    masked; Esc stops the loop."""
    cv2 = _FakeCV2([ord("i"), 0x100000 | ord("g"), -1, 27])
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    tcli(["run", "--nx", "16", "--frames", "6", "--gui", "--device", "cpu"])
    out = capsys.readouterr().out
    assert cv2.named == ["input", "output", "feature map", "kernel"]
    shown = {n for n, _ in cv2.shown}
    assert {"input", "output", "feature map", "kernel"} <= shown
    assert "spectrum" in shown           # 'g' added its windows
    assert cv2.destroyed
    assert "key 'i'" in out and "key 'g' -> True" in out
    # Esc came with the fourth frame's waitKey: no fifth frame ran
    assert [n for n, _ in cv2.shown].count("input") == 4


def test_run_gui_headless_exits_with_its_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", _FakeCV2([], fail_windows=True))
    with pytest.raises(SystemExit, match="display"):
        tcli(["run", "--nx", "16", "--frames", "2", "--gui", "--device",
              "cpu"])


def _jax_checkpoint(path, nx=32, layers=2, seed=0):
    """A checkpoint of the JAX engine's net (the format both packages
    read)."""
    from spectralae.cli.main import _make_engine
    from spectralae.io import checkpoint as jckpt
    args = types.SimpleNamespace(nx=nx, ny=None, depth=3, seed=seed,
                                 param_file=None, layers=layers)
    eng = _make_engine(args)
    jckpt.save(path, eng.params, eng.spec, extra={"step": 0})
    return path


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_eval_matches_jax_eval(tmp_path, capsys, domain):
    from spectralae.cli.main import main as jcli
    ck = _jax_checkpoint(tmp_path / "ck")
    argv = ["eval", "--from-ckpt", str(ck), "--domain", domain, "--steps",
            "2", "--batch", "2"]
    tcli(argv + ["--device", "cpu"])
    (got,) = _records(capsys.readouterr().out)
    jcli(argv)
    (want,) = _records(capsys.readouterr().out)
    assert got["frames"] == want["frames"] == 4 and got["device"] == "cpu"
    for k in ("mse_per_pixel", "psnr_db"):
        assert rel(got[k], want[k]) < TOL, k


def test_eval_of_an_artifact_equals_eval_of_its_checkpoint(tmp_path, capsys):
    ck = _jax_checkpoint(tmp_path / "ck")
    tcli(["export", "--from-ckpt", str(ck), "--out", str(tmp_path / "art"),
          "--what", "both", "--device", "cpu"])
    tcli(["eval", "--from-ckpt", str(ck), "--device", "cpu", "--steps", "2"])
    tcli(["eval", "--model", str(tmp_path / "art" / "forward"), "--device",
          "cpu", "--steps", "2"])
    a, b = _records(capsys.readouterr().out)
    assert a["frames"] == b["frames"] == 8
    assert rel(a["mse_per_pixel"], b["mse_per_pixel"]) < 1e-6
    with pytest.raises(SystemExit, match="'forward' artifact"):
        tcli(["eval", "--model", str(tmp_path / "art" / "encode"),
              "--device", "cpu"])


def _static_npy(path, n=12, size=32, seed=0):
    rng = np.random.default_rng(seed)
    frames = np.repeat(rng.integers(0, 255, size=(1, size, size, 3))
                       .astype(np.uint8), n, axis=0)
    np.save(path, frames)
    return path


def test_stream_coord_matches_jax_cli_records(tmp_path, capsys):
    """Both CLIs resume one checkpoint and stream six frames of a static
    scene through both pairs (blocks of three, round robin)."""
    from spectralae.cli.main import main as jcli
    from spectralae.io import checkpoint as jckpt
    src = _static_npy(tmp_path / "frames.npy")
    ck = _jax_checkpoint(tmp_path / "ck")
    argv = ["train", "--nx", "32", "--steps", "6", "--batch", "1", "--mode",
            "stream", "--domain", "coord", "--stream-k", "3",
            "--train-pair", "all", "--lr", "0.2", "--log-every", "1",
            "--source", str(src), "--resume", str(ck)]
    tcli(argv + ["--device", "cpu", "--ckpt", str(tmp_path / "t")])
    got = [r for r in _records(capsys.readouterr().out) if "mse" in r]
    jcli(argv + ["--ckpt", str(tmp_path / "j")])
    want = [r for r in _records(capsys.readouterr().out) if "mse" in r]
    assert [(r["step"], r["pair"]) for r in got] == \
        [(r["step"], r["pair"]) for r in want] == \
        [(k, k // 3) for k in range(6)]
    for g, w in zip(got, want):
        assert rel(g["mse"], w["mse"]) < TOL
    tp, _, _, t_extra = tckpt.load(tmp_path / "t")
    jp, _, _, j_extra = jckpt.load(tmp_path / "j")
    assert t_extra["step"] == j_extra["step"] == 6
    for a, b in zip(tp.stages, jp.stages):
        assert rel(a.c, np.asarray(b.c)) < TOL
        assert rel(a.b, np.asarray(b.b)) < TOL


def test_stream_coord_descends_checkpoints_and_resumes(tmp_path, capsys):
    src = _static_npy(tmp_path / "frames.npy", n=24)
    ck = tmp_path / "ck"
    argv = ["train", "--device", "cpu", "--nx", "32", "--batch", "1",
            "--mode", "stream", "--domain", "coord", "--stream-k", "6",
            "--log-every", "1", "--source", str(src), "--ckpt", str(ck)]
    tcli(argv + ["--steps", "12", "--ckpt-every", "6"])
    first = [r["mse"] for r in _records(capsys.readouterr().out)]
    assert len(first) == 12 and first[-1] < 0.5 * first[0]
    assert tckpt.load(ck)[3]["step"] == 12
    tcli(argv + ["--steps", "15", "--resume", str(ck)])
    out = capsys.readouterr().out
    resumed = _records(out)
    assert "resumed from" in out
    assert [r["step"] for r in resumed] == [12, 13, 14]
    assert resumed[0]["mse"] < 0.5 * first[0]


def test_stream_coord_refuses_the_frame_sweep():
    with pytest.raises(SystemExit, match="momentum-domain only"):
        tcli(["train", "--device", "cpu", "--nx", "16", "--steps", "2",
              "--mode", "stream", "--domain", "coord", "--train-pair", "all",
              "--pair-sweep", "frame"])


def _write_sources(tmp_path, n=4, size=16):
    """The same frames as a .npy stack, a C444 .y4m and a PNG directory."""
    from spectralae_torch.viz.png import write_png
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)
    np.save(tmp_path / "v.npy", frames)
    with open(tmp_path / "v.y4m", "wb") as fh:
        fh.write(f"YUV4MPEG2 W{size} H{size} F30:1 Ip C444\n".encode())
        for f in frames:
            fh.write(b"FRAME\n" + np.ascontiguousarray(
                np.moveaxis(f, -1, 0)).tobytes())
    (tmp_path / "pngs").mkdir()
    for i, f in enumerate(frames):
        write_png(tmp_path / "pngs" / f"f_{i:02d}.png", f)
    return {"npy": tmp_path / "v.npy", "y4m": tmp_path / "v.y4m",
            "png": tmp_path / "pngs"}


@pytest.mark.parametrize("kind", ["npy", "y4m", "png"])
def test_train_serve_eval_and_run_read_file_sources(tmp_path, capsys, kind):
    src = str(_write_sources(tmp_path)[kind])
    tcli(["train", "--device", "cpu", "--nx", "16", "--steps", "2",
          "--batch", "2", "--source", src, "--log-every", "1", "--ckpt",
          str(tmp_path / "ck")])
    recs = _records(capsys.readouterr().out)
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in recs)
    tcli(["export", "--from-ckpt", str(tmp_path / "ck"), "--out",
          str(tmp_path / "art"), "--device", "cpu"])
    tcli(["serve", "--model", str(tmp_path / "art"), "--device", "cpu",
          "--source", src, "--steps", "3", "--batch", "1"])
    rec = _records(capsys.readouterr().out)[-1]
    assert rec["frames"] == 3
    tcli(["eval", "--from-ckpt", str(tmp_path / "ck"), "--device", "cpu",
          "--source", src, "--steps", "5", "--batch", "2"])
    rec = _records(capsys.readouterr().out)[-1]
    # a .npy or .y4m source ends after its 4 frames; a directory loops
    assert rec["frames"] == (10 if kind == "png" else 4)
    assert np.isfinite(rec["mse_per_pixel"])
    tcli(["run", "--device", "cpu", "--nx", "16", "--frames", "3",
          "--source", src, "--keys", "1", "--outdir", str(tmp_path / "v")])
    assert "mse:" in capsys.readouterr().out
