"""The port's benchmark harness (``spectralae_torch.bench``) on the CPU:
the chained timer, the row recorder and its physicality guard, the row
groups of the JAX package's ``bench.py`` at a small size (each writing
exactly that group's keys), the final JSON line, and the CLI's refusal of
``--device cuda`` without a card."""

import json

import pytest
import torch

from spectralae_torch import bench as B
from spectralae_torch.cli import main as cli
from spectralae_torch.core import roofline as rl

TINY = dict(links=1, trials=1)


def _ctx(nx=32):
    return B.Ctx(torch.device("cpu"), B.Bench(path=None), nx=nx, **TINY)


def _row(key):
    """A timed row's keys, as Bench.record writes them."""
    return {key, key + ":median", key + ":device_ms"}


@pytest.mark.parametrize("n,warmup,trials", [(3, 1, 2), (1, 0, 1),
                                             (5, 2, 3)])
def test_time_chained_runs_its_links(n, warmup, trials):
    """warmup + trials·n links, each trial's chain from x0; floor <=
    median; no device time on the CPU."""
    seen = []

    def step(x):
        seen.append(float(x))
        return None, x + 1
    t = B.time_chained(step, torch.zeros(()), n=n, warmup=warmup,
                       trials=trials)
    assert len(seen) == warmup + trials * n
    assert seen[warmup:] == [float(i) for i in range(n)] * trials
    assert 0 < t.best <= t.median and t.device is None


def test_time_chained_live_chain():
    """Consume mode: each trial goes on from the last live value, and the
    list holds the live buffer again."""
    seen = []

    def step(x):
        seen.append(float(x))
        return None, x + 1
    holder = [torch.zeros(())]
    B.time_chained(step, holder, n=2, warmup=1, trials=3, live_chain=True)
    assert seen == [float(i) for i in range(7)]
    assert len(holder) == 1 and float(holder[0]) == 7.0


def test_record_writes_the_row(tmp_path):
    path = tmp_path / "details.json"
    bench = B.Bench(path=str(path))
    basis = bench.record(B.Timing(2e-3, 3e-3, None), "row_ms", "row_per_s",
                         10.0, cost=(4e6, 8e6))
    assert basis == 2e-3
    r = json.loads(path.read_text())
    assert r["row_ms"] == 2.0 and r["row_ms:median"] == 3.0
    assert r["row_ms:device_ms"] is None
    assert r["row_per_s"] == 5000.0
    assert r["util[row_ms]"] == rl.utilization(4e6, 8e6, 2e-3, None)
    bench.record(B.Timing(2e-3, 3e-3, 1.5e-3), "dev_ms")
    assert bench.results["dev_ms:device_ms"] == 1.5
    assert "util[dev_ms]" not in bench.results


def test_record_physicality_guard():
    """A floor implying more FLOP/s than the peak is re-based on the
    median; counted bytes above the bandwidth are marked, with the
    analytic percentage beside them."""
    peaks = rl.Peaks("card", 1e12, 1e9)
    bench = B.Bench(path=None, peaks=peaks)
    basis = bench.record(B.Timing(1e-6, 1e-2, 1e-2), "row_ms", "rate",
                         1.0, cost=(1e8, 1e8), analytic_bytes=1e6)
    r = bench.results
    assert basis == 1e-2 and r["row_ms"] == 10.0
    assert r["row_ms:floor_discarded_ms"] == 1e-3
    assert "row_ms:note" in r and r["rate"] == 100.0
    util = r["util[row_ms]"]
    assert util["pct_peak_flops"] == 1.0
    assert util["pct_peak_bw"] == 1000.0 and util["bytes_overcounted"]
    assert util["pct_peak_bw_analytic"] == 10.0
    assert util["analytic_gb"] == 0.001
    # a floor within the peak stays the basis
    bench.record(B.Timing(1e-3, 2e-3, None), "ok_ms", cost=(1e8, 1e5))
    assert r["ok_ms"] == 1.0 and "ok_ms:floor_discarded_ms" not in r
    assert "bytes_overcounted" not in r["util[ok_ms]"]


def test_fail_records_the_error():
    bench = B.Bench(path=None)
    bench.fail("big_ms", torch.OutOfMemoryError("CUDA out of memory"))
    assert bench.results["big_ms"] is None
    assert bench.results["big_ms:error"].startswith("OutOfMemoryError: CUDA")


@pytest.fixture(scope="module")
def headline():
    """The headline window at 32², one link a trial."""
    ctx = _ctx()
    hl = B.Headline(ctx).window1()
    return ctx, hl


HEADLINE_KEYS = set().union(*(
    _row(f"fft_burst_100_ms[{impl}]")
    | {f"fft_backprop_iters_per_sec_256[{impl}]",
       f"fft_backprop_iters_per_sec_256_median[{impl}]"}
    for impl in ("corr", "pallas-fused", "pallas", "itergrid", "dft",
                 "fft"))) | {"util[fft_burst_100_ms[corr]]"}


def test_headline_group_keys(headline):
    ctx, hl = headline
    # (the windows' keys start with "headline")
    assert {k for k in ctx.bench.results
            if not k.startswith("headline")} == HEADLINE_KEYS
    assert hl.best_impl in B.HEADLINE_IMPLS
    util = ctx.bench.results["util[fft_burst_100_ms[corr]]"]
    assert util["gflop"] > 0 and util["gb"] > 0


def test_headline_windows_and_final_line(headline):
    """A later window re-times the best impl; the final line has bench.py's
    fields, its value the median of the window floors."""
    ctx, hl = headline
    hl.window("w6")
    win = ctx.bench.results["headline_window[w6]"]
    assert win["impl"] == hl.best_impl and win["device_iters_per_sec"] is None
    line = hl.summary()
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "median",
                         "spread_pct", "stream_sustained"}
    assert line["metric"] == "fft_backprop_iters_per_sec_256"
    assert line["unit"] == "iters/s"
    assert len(hl.floors) == 2
    assert line["value"] == round(sum(hl.floors) / 2, 1)
    assert line["vs_baseline"] == round(
        sum(hl.floors) / 2 / B.REFERENCE_FFT_ITERS_PER_SEC_ESTIMATE, 2)
    assert line["stream_sustained"] is None
    r = ctx.bench.results
    assert r["headline_windows_floor"] == hl.floors
    assert {"headline_windows_median", "headline_range_pct",
            "headline_basis"} <= set(r)
    json.dumps(line)


def test_forward_group_keys():
    ctx = _ctx()
    B.forward(ctx)
    assert set(ctx.bench.results) == (
        _row("forward_fft_3layer_256_ms") | _row("forward_coord_3layer_256_ms")
        | {"forward_fft_3layer_256_fps", "util[forward_fft_3layer_256_ms]",
           "util[forward_coord_3layer_256_ms]"})


def test_steps_group_keys():
    ctx = _ctx()
    B.steps(ctx)
    assert set(ctx.bench.results) == (
        _row("modern_fft_step_b8_ms") | _row("fft_burst_dp_b8_100_ms")
        | {"modern_fft_frames_per_sec", "fft_burst_dp_frame_iters_per_sec",
           "util[modern_fft_step_b8_ms]", "util[fft_burst_dp_b8_100_ms]"})
    # the batched step's cost sees its matmuls (the K1 route is opaque)
    assert ctx.bench.results["util[modern_fft_step_b8_ms]"]["gb"] > 0


def test_conv_group_keys():
    """At 64² (the 33×33 kernel needs a frame at least that wide)."""
    ctx = _ctx(nx=64)
    B.conv(ctx)
    want = {"conv_coord_5x5_b8_ms[pallas]", "util[conv_coord_5x5_b8_ms"
            "[pallas]]"} | _row("conv_coord_5x5_b8_ms[pallas]")
    for nk in (5, 13, 33):
        for kind in ("coord", "spectral"):
            key = f"conv_{kind}_{nk}x{nk}_b8_ms"
            want |= _row(key) | {f"util[{key}]"}
        want.add(f"spectral_speedup_{nk}x{nk}")
    r = ctx.bench.results
    assert set(r) == want
    assert all(r[f"spectral_speedup_{nk}x{nk}"] > 0 for nk in (5, 13, 33))


@pytest.mark.parametrize("argv", [["bench", "--device", "cuda"],
                                  ["bench", "--quick"]])
def test_cli_bench_refuses_cuda_without_a_card(monkeypatch, argv,
                                               tmp_path):
    """``spectralae-torch bench`` (and ``python -m spectralae_torch.bench``)
    default to the card and exit non-zero with the reason without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="torch finds no CUDA device") as e:
        cli.main(argv)
    assert e.value.code != 0
    with pytest.raises(SystemExit, match="torch finds no CUDA device"):
        B.main(argv[1:])
    assert not (tmp_path / B.DEFAULT_OUT).exists()


@pytest.mark.parametrize("err,recorded", [
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (ValueError("a shape the kernel refuses"), False)])
def test_large_tier_rows_record_only_out_of_memory(monkeypatch, err,
                                                   recorded):
    """A large-tier row that runs out of memory records ``:error`` and
    the group goes on; any other error ends the run."""
    def refuse(*a, **k):
        raise err
    monkeypatch.setattr(B, "_pair_burst", refuse)
    ctx = B.Ctx(torch.device("cpu"), B.Bench(path=None), quick=True,
                **TINY)
    if recorded:
        B.big_bursts(ctx)
        assert B.failed_rows(ctx.bench.results) == ["fft_burst_100_ms_2048"]
    else:
        with pytest.raises(ValueError, match="refuses"):
            B.big_bursts(ctx)
        assert B.failed_rows(ctx.bench.results) == []


@pytest.mark.parametrize("fail", [False, True])
def test_run_exits_non_zero_when_a_row_failed(monkeypatch, tmp_path, capsys,
                                              fail):
    """The final line is printed either way; a row that did not run makes
    the exit code non-zero."""
    line = {"metric": "fft_backprop_iters_per_sec_256", "value": 1.0}

    def run_all(ctx, xl_rows=False):
        if fail:
            ctx.bench.fail("fft_burst_100_ms_8192",
                           torch.OutOfMemoryError("CUDA out of memory"))
        return line
    monkeypatch.setattr(B, "run_all", run_all)
    out = tmp_path / "details.json"
    argv = ["--device", "cpu", "--out", str(out)]
    if fail:
        with pytest.raises(SystemExit, match="fft_burst_100_ms_8192") as e:
            B.main(argv)
        assert e.value.code != 0
    else:
        assert B.main(argv) == line
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == line
    assert json.loads(out.read_text())["device"] == {"name": "cpu"}


def test_taps13_group_keys(headline):
    """The 13×13 rows (corr, and the fused ω-space step on 169 taps)."""
    ctx, hl = headline
    before = set(ctx.bench.results)
    B.taps13(ctx, hl)
    got = set(ctx.bench.results) - before
    assert got == set().union(*(
        _row(f"fft_burst_100_ms_13x13[{impl}]")
        | {f"fft_backprop_iters_per_sec_256_13x13[{impl}]"}
        for impl in ("corr", "pallas-fused"))) | {
            "util[fft_burst_100_ms_13x13[corr]]"}
