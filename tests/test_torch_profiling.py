"""The recorder of :mod:`spectralae_torch.core.profiling` in the train step
(CPU).

- Off (no profiler session, no ``enable()``), a step records nothing,
  enters no ``record_function``, registers no autograd hook and records no
  CUDA event.
- Under ``torch.profiler`` each step is one ``train_step`` tree of the
  layer spans, each pooling with a gradient has its ``pool.grad`` inside
  ``backward``, and the host times match the exported trace's clock.
- ``opaque``'s counters against the roofline tally's kernel calls, the
  K2 / library route counters, and the CLI's ``spans.json`` and
  ``steps_per_sec``.

The steps take the card's routes here: every spectral conv through K1's
Function and every coord conv of a K2 shape through K2's, their plain
versions running on the CPU.
"""

import collections
import functools
import json
import statistics

import numpy as np
import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.cli.main import main as tcli
from spectralae_torch.core import profiling
from spectralae_torch.core import roofline
from spectralae_torch.core import types as ttypes
from spectralae_torch.ops import coord as tcoord
from spectralae_torch.ops import spectral as tspec
from spectralae_torch.train import modern

torch.set_num_threads(1)

# the reference's net at 32²: D 3, M 10, 5×5 taps, three stage pairs
SCALES = (2, 2, 2, -2, -2, -2)
DEPTHS = [(10, 3), (10, 10), (10, 10), (10, 10), (10, 10), (3, 10)]
STEP_SPANS = {"train_step", "forward", "backward", "update"}
LAYER_SPANS = {
    "fft": {"transform": 2, "pool": 6, "pool.grad": 5, "spectral_conv": 6,
            "spectral_conv.grad": 6, "kernel_spectra": 6},
    "coord": {"pool": 6, "pool.grad": 5, "coord_conv": 6,
              "coord_conv.grad": 6}}


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    """No store and the recorder off before and after each test; the
    card's kernel routes taken on the CPU."""
    monkeypatch.setattr(profiling, "_store", None)
    monkeypatch.setattr(tspec, "kernel_route", lambda x: True)
    monkeypatch.setattr(tcoord, "kernel_route", lambda x: True)
    profiling.disable()
    yield
    profiling.disable()


def _net(seed=0, batch=2, n=32):
    rng = np.random.default_rng(seed)
    params = ttypes.params_from_numpy(
        [(rng.uniform(-1, 1, (m, d, 5, 5)), rng.uniform(-1, 1, m))
         for m, d in DEPTHS])
    x = torch.from_numpy(
        rng.uniform(0, 255, (batch, 3, n, n)).astype(np.float32))
    return params, ttypes.init_opt_state(params), x


def _steps(domain, n_steps, step_fn=None, optimizer=None):
    params, opt, x = _net()
    if optimizer is not None:
        opt = optimizer.init(params)
    for _ in range(n_steps):
        if step_fn is None:
            res = modern.train_step(params, opt, x, SCALES, domain=domain)
        else:
            res = step_fn(params, opt, x, SCALES)
        params, opt = res.params, res.opt
    return res


def _profiled(domain, n_steps, step_fn=None, optimizer=None,
              trace_path=None):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _steps(domain, n_steps, step_fn, optimizer)
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    return profiling.snapshot()


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_off_records_nothing(monkeypatch, domain):
    calls = collections.Counter()

    class Counted:
        def __init__(self, what):
            self.what = what

        def __call__(self, *args, **kwargs):
            calls[self.what] += 1
            raise AssertionError(f"{self.what} called with the recorder off")

    monkeypatch.setattr(torch.profiler, "record_function",
                        Counted("record_function"))
    monkeypatch.setattr(torch.cuda, "Event", Counted("cuda_event"))
    monkeypatch.setattr(profiling, "_watch", Counted("autograd_hook"))
    res = _steps(domain, 2)
    assert torch.isfinite(res.loss)
    assert not profiling.recording
    assert profiling.snapshot() is None
    assert not calls


@pytest.mark.parametrize("domain,optimizer", [("fft", None),
                                              ("coord", None),
                                              ("fft", "adam")])
def test_each_step_is_one_tree_of_the_layer_spans(domain, optimizer):
    step_fn = None
    if optimizer is not None:
        optimizer = modern.make_optimizer(optimizer, 1e-3)
        step_fn = modern.make_optim_train_step(optimizer, domain=domain)
    snap = _profiled(domain, 2, step_fn, optimizer)
    assert not profiling.recording      # the session ended
    spans = snap["spans"]
    assert snap["steps"] == 2
    for ordinal in range(2):
        mine = [i for i, s in enumerate(spans) if s["step"] == ordinal]
        roots = [i for i in mine if spans[i]["parent"] is None]
        assert [spans[i]["name"] for i in roots] == ["train_step"]
        for i in mine:
            j = i
            while spans[j]["parent"] is not None:
                j = spans[j]["parent"]
            assert j == roots[0]
            s = spans[i]
            assert s["host_begin_ns"] <= s["host_end_ns"]
            assert s["device_begin_ns"] is None    # no card here
        names = collections.Counter(spans[i]["name"] for i in mine)
        assert {k: names[k] for k in STEP_SPANS} == dict.fromkeys(
            STEP_SPANS, 1)
        assert {k: v for k, v in names.items()
                if k not in STEP_SPANS} == LAYER_SPANS[domain]
    assert len(spans) == sum(1 for s in spans if s["step"] is not None)


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_each_pool_grad_lies_inside_backward(domain):
    """Every pooling whose input carries a gradient (all but the first,
    which reads the frames) has one ``pool.grad`` inside the step's
    ``backward``."""
    snap = _profiled(domain, 2)
    for ordinal in range(2):
        mine = [s for s in snap["spans"] if s["step"] == ordinal]
        (back,) = [s for s in mine if s["name"] == "backward"]
        grads = [s for s in mine if s["name"] == "pool.grad"]
        pools = [s for s in mine if s["name"] == "pool"]
        assert len(grads) == len(pools) - 1 == 5
        for g in grads:
            assert back["host_begin_ns"] <= g["host_begin_ns"] \
                <= g["host_end_ns"] <= back["host_end_ns"]


@pytest.mark.parametrize("domain,calls", [("fft", {"cmul_contract": 17,
                                                   "spectral_resize": 11}),
                                          ("coord", {"_valid_corr": 2})])
def test_kernel_counters_match_the_roofline_tally(domain, calls):
    params, opt, x = _net()
    profiling.enable()
    _, _, tally = roofline._count(modern.train_step, (params, opt, x, SCALES),
                                  {"domain": domain})
    counters = profiling.snapshot()["counters"]
    kernels = {k[len("kernel."):]: v for k, v in counters.items()
               if k.startswith("kernel.")}
    assert kernels == collections.Counter(name for name, _, _ in tally)
    assert kernels == calls
    if domain == "coord":      # K2 where M·D ≤ 64: the 3 ↔ 10 stages
        assert counters["coord_conv.k2"] == 2
        assert counters["coord_conv.cudnn"] == 4


def test_a_wrapper_inside_a_wrapper_counts_once():
    @_kernels.opaque
    def inner(t):
        return t + 1

    @_kernels.opaque
    def outer(t):
        return inner(t) * 2

    outer(torch.zeros(2))
    profiling.enable()
    outer(torch.zeros(2))
    inner(torch.zeros(2))
    profiling.disable()
    outer(torch.zeros(2))
    assert profiling.snapshot()["counters"] == {"kernel.outer": 1,
                                                "kernel.inner": 1}


def test_a_new_session_starts_a_fresh_store():
    _profiled("fft", 1)
    snap = _profiled("fft", 2)
    assert snap["steps"] == 2
    assert {s["step"] for s in snap["spans"]} == {0, 1}
    assert profiling.snapshot()["steps"] == 2
    _steps("fft", 1)            # no session: the store stays
    assert profiling.snapshot()["steps"] == 2


def test_host_times_match_the_exported_trace(tmp_path):
    snap = _profiled("fft", 3, trace_path=tmp_path / "trace.json")
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = trace["baseTimeNanoseconds"]
    in_trace = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            in_trace[e["name"]].append(base + float(e["ts"]) * 1e3)
    in_store = collections.defaultdict(list)
    for s in snap["spans"]:
        in_store[s["name"]].append(s["host_begin_ns"])
    assert set(in_store) <= set(in_trace)
    gaps = []
    for name, begins in in_store.items():
        assert len(in_trace[name]) == len(begins), name
        gaps += [abs(a - b) for a, b in zip(sorted(in_trace[name]),
                                            sorted(begins))]
    assert statistics.median(gaps) < 0.2e6


def test_cli_trace_writes_spans_and_a_rate_per_interval(tmp_path, capsys):
    tcli(["train", "--device", "cpu", "--nx", "16", "--batch", "1",
          "--steps", "3", "--log-every", "1", "--trace",
          str(tmp_path / "tr")])
    spans = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert spans["steps"] == 3
    assert [s["step"] for s in spans["spans"]
            if s["name"] == "train_step"] == [0, 1, 2]
    assert not profiling.recording
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    rates = [r["steps_per_sec"] for r in recs]
    assert rates[0] is None and all(r > 0 for r in rates[1:])
    assert len(rates) == 3


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_a_tied_diverse_step_records_its_spans(domain):
    """The tied, kernel-diverse step (``sym``, ``maxdiff``): one
    ``diversity`` span a stage (the pair's kernels once, at the encoder),
    two ``tie`` spans (the fold and the re-tie), each inside its step, and
    in the fft domain one ``kernel_spectra`` span and one
    ``kernel_spectra.shared`` read a pair instead of a spectrum a stage."""
    step = functools.partial(modern.train_step, domain=domain, sym=True,
                             maxdiff=True)
    snap = _profiled(domain, 2, step)
    spans = snap["spans"]
    for ordinal in range(2):
        names = collections.Counter(s["name"] for s in spans
                                    if s["step"] == ordinal)
        assert names["diversity"] == len(DEPTHS)
        assert names["tie"] == 2
        want = len(DEPTHS) // 2 if domain == "fft" else 0
        assert names["kernel_spectra"] == want
    updates = [i for i, s in enumerate(spans) if s["name"] == "update"]
    retie = [s for s in spans if s["name"] == "tie"][1::2]
    assert [s["parent"] for s in retie] == updates
    shared = len(DEPTHS) // 2 * 2 if domain == "fft" else 0
    assert snap["counters"].get("kernel_spectra.shared", 0) == shared
    assert not any(k.startswith("kernel.kernel_spectra")
                   for k in snap["counters"])
