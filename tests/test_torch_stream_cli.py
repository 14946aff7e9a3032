"""The ``train --mode stream|burst`` CLI of the port, on the CPU.

- A few stream and burst steps train (the entry MSE falls), checkpoint and
  resume from the checkpoint; the stream options (``--train-pair all`` in
  both sweeps, ``--bf16``, ``--carry-momentum``, ``--maxdiff``,
  ``--reanchor``) run.
- A stream checkpoint written by the JAX package resumes in the port and
  the reverse: two more steps in the reader equal two more in the writer
  (1e-5 norm-relative: float32 FFT precomputes through two libraries).
- A non-finite MSE rolls back to the last good weights, which the final
  checkpoint holds.
- What the stream and burst trainers do not do exits with its reason.
"""

import json

import numpy as np
import pytest
import torch

from spectralae_torch.cli.main import main as tcli
from spectralae_torch.io import checkpoint as tckpt

torch.set_num_threads(1)

STEP_TOL = 1e-5


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def flat(params) -> np.ndarray:
    return np.concatenate([np.asarray(t).ravel() for st in params.stages
                           for t in (st.c, st.b)])


def _records(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


STREAM = ["train", "--device", "cpu", "--mode", "stream", "--nx", "32",
          "--layers", "2", "--batch", "2", "--stream-k", "3", "--iters",
          "20", "--log-every", "1"]


def test_cli_stream_trains_checkpoints_and_resumes(tmp_path, capsys):
    ck = tmp_path / "ck"
    tcli(STREAM + ["--steps", "6", "--ckpt", str(ck), "--ckpt-every", "3"])
    recs = _records(capsys.readouterr().out)
    assert [r["step"] for r in recs] == list(range(6))
    assert all(r["pair"] == 0 for r in recs)
    assert recs[-1]["mse0"] < 0.1 * recs[0]["mse0"]
    assert all(r["mseN"] < r["mse0"] for r in recs)
    _, _, opt, extra = tckpt.load(ck)
    assert extra["step"] == 6 and opt is None
    tcli(STREAM + ["--steps", "9", "--resume", str(ck), "--ckpt", str(ck)])
    out = capsys.readouterr().out
    assert "resumed from" in out
    resumed = _records(out)
    assert [r["step"] for r in resumed] == [6, 7, 8]
    # the resumed weights, not fresh ones: far below step 0's entry MSE
    assert resumed[0]["mse0"] < 0.1 * recs[0]["mse0"]
    assert tckpt.load(ck)[3]["step"] == 9


@pytest.mark.parametrize("extra", [
    ["--train-pair", "all"],
    ["--train-pair", "all", "--pair-sweep", "frame"],
    ["--train-pair", "1", "--bf16"],
    ["--carry-momentum", "--maxdiff", "--reanchor", "7"],
    ["--pallas-fft"],
    ["--pallas-fft", "--bf16", "--train-pair", "all", "--pair-sweep",
     "frame"]],
    ids=["all_block", "all_frame", "pair1_bf16", "carry_maxdiff_reanchor",
         "pallas_fft", "pallas_fft_bf16_sweep"])
def test_cli_stream_options_run(extra, capsys):
    tcli(STREAM + ["--steps", "4", "--stream-k", "2"] + extra)
    recs = _records(capsys.readouterr().out)
    assert recs and all(np.isfinite(r["mseN"]) for r in recs)
    assert {r["step"] for r in recs} == set(range(4))


@pytest.mark.parametrize("bf16", [False, True])
def test_cli_stream_pallas_fft_trains_and_resumes(tmp_path, capsys, bf16):
    """``--pallas-fft`` (with and without ``--bf16``): the entry MSE falls,
    the checkpoint resumes, and every frame's precompute took its spectra
    from the four-step rfft2 (one y-leaf and one x-leaf per frame)."""
    from spectralae_torch.ops import fft_kernels as fk
    ck = tmp_path / "ck"
    extra = ["--pallas-fft"] + (["--bf16"] if bf16 else [])
    calls = []
    real = fk.rfft2_mixed

    def spy(x, **kw):
        calls.append((tuple(x.shape), kw.get("out_dtype")))
        return real(x, **kw)
    from spectralae_torch.train import fft_corr
    fft_corr.rfft2_mixed = spy
    try:
        tcli(STREAM + extra + ["--steps", "6", "--ckpt", str(ck)])
        recs = _records(capsys.readouterr().out)
        assert [r["step"] for r in recs] == list(range(6))
        assert recs[-1]["mse0"] < 0.1 * recs[0]["mse0"]
        assert len(calls) == 6
        assert {c[1] for c in calls} == {torch.bfloat16 if bf16 else None}
        tcli(STREAM + extra + ["--steps", "8", "--resume", str(ck)])
        resumed = _records(capsys.readouterr().out)
        assert [r["step"] for r in resumed] == [6, 7]
        assert resumed[0]["mse0"] < 0.1 * recs[0]["mse0"]
    finally:
        fft_corr.rfft2_mixed = real


def test_cli_burst_trains_checkpoints_and_resumes(tmp_path, capsys):
    burst = ["train", "--device", "cpu", "--mode", "burst", "--nx", "32",
             "--layers", "2", "--batch", "2", "--iters", "10",
             "--log-every", "1", "--train-pair", "all"]
    ck = tmp_path / "ck"
    tcli(burst + ["--steps", "3", "--ckpt", str(ck)])
    recs = _records(capsys.readouterr().out)
    assert [(r["step"], r["pair"]) for r in recs] == [
        (s, p) for s in range(3) for p in range(2)]
    for r in recs:
        assert len(r["mses"]) == 11 and r["mseN"] < r["mse0"]
    tcli(burst + ["--steps", "4", "--resume", str(ck), "--ckpt", str(ck)])
    resumed = _records(capsys.readouterr().out)
    assert [r["step"] for r in resumed] == [3, 3]
    assert resumed[0]["mse0"] < recs[0]["mse0"]
    assert tckpt.load(ck)[3]["step"] == 4


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_stream_checkpoint_crosses_packages(tmp_path, capsys, direction):
    """A stream checkpoint written by one package after two steps resumes
    in the other: two more steps there equal two more in the writer."""
    from spectralae.cli.main import main as jcli
    first, second = (jcli, tcli) if direction == "jax_to_port" \
        else (tcli, jcli)
    common = ["train", "--mode", "stream", "--nx", "16", "--batch", "1",
              "--stream-k", "2", "--iters", "5", "--log-every", "1"]

    def dev(cli):       # the port's CLI defaults to the card
        return ["--device", "cpu"] if cli is tcli else []
    ck0 = tmp_path / "ck0"
    first(common + dev(first) + ["--steps", "2", "--ckpt", str(ck0)])
    outs = {}
    for name, cli in (("writer", first), ("reader", second)):
        dest = tmp_path / name
        cli(common + dev(cli) + ["--steps", "4", "--resume", str(ck0),
                                 "--ckpt", str(dest)])
        outs[name] = tckpt.load(dest)
    capsys.readouterr()
    (wp, _, _, wx), (rp, _, _, rx) = outs["writer"], outs["reader"]
    assert wx["step"] == rx["step"] == 4
    assert rel(flat(rp), flat(wp)) < STEP_TOL


def _poison(real, after):
    """Wrap a burst/stream function: from call ``after`` on, its MSEs are
    NaN."""
    calls = []

    def wrapped(*a, **kw):
        r = real(*a, **kw)
        calls.append(1)
        if len(calls) > after:
            r = r._replace(mses=r.mses * float("nan"))
        return r
    return wrapped


def test_cli_stream_rolls_back_on_a_non_finite_mse(tmp_path, capsys,
                                                   monkeypatch):
    from spectralae_torch.train import streaming
    ck = tmp_path / "ck"
    tcli(STREAM + ["--steps", "3", "--ckpt", str(ck / "one")])
    good = tckpt.load(ck / "one")[0]
    monkeypatch.setattr(streaming, "fft_stream_pair",
                        _poison(streaming.fft_stream_pair, after=1))
    capsys.readouterr()
    tcli(STREAM + ["--steps", "9", "--ckpt", str(ck / "two")])
    out = capsys.readouterr().out
    assert '"error": "non-finite mse"' in out
    params, _, _, extra = tckpt.load(ck / "two")
    # the second block diverged: the checkpoint holds the first block's
    # weights at its step
    assert extra["step"] == 3
    assert np.array_equal(flat(params), flat(good))


def test_cli_burst_rolls_back_on_a_non_finite_mse(tmp_path, capsys,
                                                  monkeypatch):
    from spectralae_torch.train import fft_dp
    burst = ["train", "--device", "cpu", "--mode", "burst", "--nx", "32",
             "--layers", "2", "--batch", "2", "--iters", "5",
             "--log-every", "1"]
    tcli(burst + ["--steps", "2", "--ckpt", str(tmp_path / "one")])
    good = tckpt.load(tmp_path / "one")[0]
    monkeypatch.setattr(fft_dp, "fft_burst_dp",
                        _poison(fft_dp.fft_burst_dp, after=2))
    capsys.readouterr()
    tcli(burst + ["--steps", "5", "--ckpt", str(tmp_path / "two")])
    assert '"error": "non-finite mse"' in capsys.readouterr().out
    params, _, _, extra = tckpt.load(tmp_path / "two")
    assert extra["step"] == 2
    assert np.array_equal(flat(params), flat(good))


@pytest.mark.parametrize("argv,match", [
    (["--mode", "stream", "--domain", "coord", "--train-pair", "all",
      "--pair-sweep", "frame"], "momentum-domain only"),
    (["--mode", "burst", "--pallas-fft"], "burst mode anchors"),
    (["--mode", "stream", "--pair-sweep", "frame"], "--train-pair all"),
    (["--mode", "burst", "--train-pair", "2"], "out of range")])
def test_cli_stream_and_burst_refuse(argv, match):
    with pytest.raises(SystemExit, match=match):
        tcli(["train", "--device", "cpu", "--nx", "16", "--steps", "1"]
             + argv)
