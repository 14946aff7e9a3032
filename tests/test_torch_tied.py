"""The tied, kernel-diverse net on the batched step (``sym``, ``maxdiff``)
against the benchmark's plain float64 reference
(``benchmark/reference/tied.py``), on the CPU.

A small net with seeded random weights: 32² frames, D 3, M 4, 5×5 taps,
two stage pairs, batch 2, weights uniform in ±3 and frames in [0, 255] as
the benchmark draws them.  Tolerances, with their reasons:

- ``LOSS_TOL`` 1e-5 relative: the float32 forward's rounding, which reads
  ~1e-7 here (the benchmark's cells read up to 1.6e-6 at 1024²);
- ``GRAD_TOL`` 1e-5 of a leaf's norm: float32 sums of the gradients and
  of the repulsion, read ~1e-7 to 1e-6 here;
- ``STEP_TOL`` 1e-5 absolute on an updated weight: the update is
  ``lr·(1−α)·g/max(|g|, 10)`` plus inertia, at most 0.02 + its inertia,
  and float32 holds a weight of magnitude 3 to 2.4e-7; the elements whose
  reference gradient is under 1e-5 of their leaf's largest take the sign
  of their update from rounding and are left out, as the benchmark's
  comparison leaves them (``benchmark/compare.py``);
- ``DIV_TOL`` 1e-5 of a leaf's norm for the repulsion against the
  pairwise form: the Gram form's cancellation error, ~1e-7 for kernels as
  far apart as these (``losses.kernel_repulsion``).
"""

import math
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import tied as ref
from spectralae_torch.core import profiling
from spectralae_torch.core.types import (AEParams, ConvStage,
                                         init_opt_state, params_from_numpy)
from spectralae_torch.losses import losses
from spectralae_torch.model import autoencoder as model
from spectralae_torch.optim.update import tree_update
from spectralae_torch.train import modern

torch.set_num_threads(1)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
STEP_TOL = 1e-5
DIV_TOL = 1e-5
SCALES = (2, 2, -2, -2)
DEPTHS = [(4, 3), (4, 4), (4, 4), (3, 4)]
CFG = {"d": 3, "depth": 4, "nk": 5, "nl": 5, "scale": 2, "pairs": 2,
       "lr": 0.2, "alpha": 0.9, "w0": 1.0, "w1": 10.0}
FLAGS = {"sym": dict(sym=True, maxdiff=False),
         "maxdiff": dict(sym=False, maxdiff=True),
         "both": dict(sym=True, maxdiff=True)}
CELL = "m50k5tied.step-fft.1024-b16"


def _net(seed=0, batch=2, n=32, steps=2):
    rng = np.random.default_rng(seed)
    params = params_from_numpy(
        [(rng.uniform(-3, 3, (m, d, 5, 5)), rng.uniform(-3, 3, m))
         for m, d in DEPTHS])
    xs = [torch.from_numpy(rng.uniform(0, 255, (batch, 3, n, n))
                           .astype(np.float32)) for _ in range(steps)]
    return params, init_opt_state(params), xs


def _tied(params: AEParams) -> AEParams:
    """``params`` with each decoder's kernels its encoder's ``cᵀ``."""
    for p in range(params.n_pairs):
        enc, dec = params.pair(p)
        params = params.replace_pair(p, enc, ConvStage(
            c=enc.c.transpose(0, 1).contiguous(), b=dec.b))
    return params


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


# ------------------------------------------------- the step, against tied.py

@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_step_matches_the_reference(domain, flags):
    """Two steps from untied random weights: each step's loss, its folded
    and combined gradients (the optimizer's state), the ``w1·g_div`` it
    returned, its update and the re-tie, against the reference followed
    from the same weights."""
    kw = FLAGS[flags]
    cfg = dict(CFG, **kw)
    params, opt, xs = _net()
    states, results = [params.leaves()], []
    for x in xs:
        res = modern.train_step(params, opt, x, SCALES, domain=domain, **kw)
        results.append(res)
        params, opt = res.params, res.opt
        states.append(params.leaves())
    want = ref.follow(states[:-1], xs, cfg, domain, rows=1)
    for k, res in enumerate(results):
        r_loss = want["losses"][k]
        assert abs(float(res.loss) - r_loss) <= LOSS_TOL * abs(r_loss)
        for g, w in zip(res.opt.prev_grad.leaves(), want["grads"][k]):
            assert _rel(g, w) <= GRAD_TOL
        for before, after, dw, g in zip(states[k], states[k + 1],
                                        want["updates"][k],
                                        want["grads"][k]):
            keep = g.abs() >= 1e-5 * g.abs().max()
            assert keep.float().mean() > 0.9
            torch.testing.assert_close(
                after.double()[keep], (before.double() - dw)[keep],
                rtol=0.0, atol=STEP_TOL)
        if kw["maxdiff"]:
            for d, w in zip(res.div.leaves(), want["div"][k]):
                assert _rel(d, w) <= GRAD_TOL
        else:
            assert res.div is None and want["div"][k] is None
        if kw["sym"]:
            for p in range(res.params.n_pairs):
                enc, dec = res.params.pair(p)
                assert torch.equal(dec.c, enc.c.transpose(0, 1))
                menc, mdec = res.opt.mom.pair(p)
                assert torch.equal(mdec.c, menc.c.transpose(0, 1))


def _parent_step(params, opt, x, scales, *, lr=0.2, alpha=0.9, **loss_kw):
    """The untied step as it was before the objectives: autograd of the
    reconstruction loss, float32 gradients, :func:`tree_update`."""
    leaves = [t.detach().requires_grad_() for t in params.leaves()]
    loss = modern.reconstruction_loss(AEParams.from_leaves(leaves), x,
                                      scales, **loss_kw)
    grads = torch.autograd.grad(loss, leaves)
    grads = AEParams.from_leaves([g.to(torch.float32) for g in grads])
    new, mom, pg = tree_update(params, grads, opt.mom, opt.prev_grad, lr,
                               alpha)
    return loss.detach(), new, mom, pg


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_both_flags_off_is_the_untied_step_bit_for_bit(domain, remat):
    params, opt, xs = _net()
    for x in xs:
        res = modern.train_step(params, opt, x, SCALES, domain=domain,
                                remat=remat)
        loss, new, mom, pg = _parent_step(params, opt, x, SCALES,
                                          domain=domain, remat=remat)
        assert res.div is None
        assert torch.equal(res.loss, loss)
        for a, b in zip(res.params.leaves() + res.opt.mom.leaves()
                        + res.opt.prev_grad.leaves(),
                        new.leaves() + mom.leaves() + pg.leaves()):
            assert torch.equal(a, b)
        params, opt = res.params, res.opt


def test_both_flags_off_optimizer_step_is_unchanged_bit_for_bit():
    params, _, xs = _net()
    optimizer = modern.make_optimizer("adam", 1e-2)
    step = modern.make_optim_train_step(optimizer)
    state = optimizer.init(params)
    res = step(params, state, xs[0], SCALES)
    leaves = [t.detach().requires_grad_() for t in params.leaves()]
    loss = modern.reconstruction_loss(AEParams.from_leaves(leaves), xs[0],
                                      SCALES)
    grads = AEParams.from_leaves(list(torch.autograd.grad(loss, leaves)))
    new, new_state = optimizer.update(params, grads, state)
    assert res.div is None and torch.equal(res.loss, loss.detach())
    assert new_state["count"] == res.opt["count"] == 1
    for a, b in zip(res.params.leaves(), new.leaves()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flag", ["sym", "maxdiff"])
@pytest.mark.parametrize("where", ["stage_conv", "axis_name"])
def test_objectives_refuse_the_model_and_data_axes(flag, where):
    params, opt, xs = _net(steps=1)
    with pytest.raises(ValueError, match="not supported"):
        modern.train_step(params, opt, xs[0], SCALES, **{flag: True},
                          **{where: object()})


# ---------------------------------------------------------- the forwards

@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_forward_fft_computes_each_pair_spectrum_once(remat, monkeypatch):
    """With ``sym`` the spectra are computed once a pair and read by the
    decoder through its transposed view: the counter reads the pair
    count, the output is the untied forward's with ``f = cᵀ``, and the
    encoder's kernels get both stages' gradients, ``dc + dfᵀ``."""
    monkeypatch.setattr(profiling, "_store", None)
    params, _, xs = _net(steps=1)
    x = xs[0]
    leaves = [t.clone().requires_grad_() for t in params.leaves()]
    profiling.enable()
    try:
        out = model.forward_fft(AEParams.from_leaves(leaves), x, SCALES,
                                remat=remat, sym=True)
        snap = profiling.snapshot()
    finally:
        profiling.disable()
    n_pairs = len(DEPTHS) // 2
    assert snap["counters"] == {"kernel_spectra.shared": n_pairs}
    assert sum(s["name"] == "kernel_spectra"
               for s in snap["spans"]) == n_pairs
    tied = [t.clone().requires_grad_()
            for t in _tied(params).leaves()]
    want = model.forward_fft(AEParams.from_leaves(tied), x, SCALES,
                             remat=remat)
    assert _rel(out, want) <= 1e-6
    g = torch.autograd.grad(out.square().mean(), leaves, allow_unused=True)
    gw = torch.autograd.grad(want.square().mean(), tied)
    n = len(DEPTHS)
    for p in range(n_pairs):
        both = gw[2 * p] + gw[2 * (n - 1 - p)].transpose(0, 1)
        assert _rel(g[2 * p], both) <= 1e-5
        assert g[2 * (n - 1 - p)] is None       # the decoder's own c unread


def test_forward_coord_convolves_the_decoder_with_c_transposed():
    params, _, xs = _net(steps=1)
    got = model.forward_coord(params, xs[0], SCALES, sym=True)
    want = model.forward_coord(_tied(params), xs[0], SCALES)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --------------------------------------------------------- the repulsion

@pytest.mark.parametrize("shape", [(4, 3), (5, 5), (3, 6)])
def test_stage_diversity_matches_the_pairwise_forms(shape):
    """The Gram form against the port's pairwise ``diversity_gradients``
    and the reference's direct difference form."""
    a, b = shape
    g = torch.Generator().manual_seed(a * 10 + b)
    c = (torch.rand(a, b, 5, 5, generator=g) * 6 - 3)
    f = (torch.rand(b, a, 5, 5, generator=g) * 6 - 3)
    bias = torch.rand(a, generator=g) * 6 - 3
    p = torch.rand(b, generator=g) * 6 - 3
    cd, bd = losses.stage_diversity(c, bias)
    fd, pd = losses.stage_diversity(f, p)
    assert cd.dtype == bd.dtype == torch.float32
    pw = losses.diversity_gradients(*(t.double() for t in (c, f, bias, p)))
    for got, want in zip((cd, fd, bd, pd), pw):
        assert _rel(got, want) <= DIV_TOL
    assert _rel(cd, ref.kernel_repulsion(c.double())) <= DIV_TOL
    assert _rel(bd, ref.bias_repulsion(bias.double())) <= DIV_TOL
    assert losses.stage_diversity(None, bias)[0] is None


def test_stage_diversity_takes_identical_kernels_as_no_pair():
    """Two kernels that coincide add nothing, as the pairwise form's zero
    difference does (its distance counted as 1), where the Gram form's
    distance is a rounding residue."""
    g = torch.Generator().manual_seed(5)
    c = torch.rand(4, 3, 5, 5, generator=g) * 6 - 3
    c[2, 1] = c[0, 0]
    cd, _ = losses.stage_diversity(c, torch.arange(4.0))
    want = ref.kernel_repulsion(c.double())
    assert torch.isfinite(cd).all()
    assert _rel(cd, want) <= DIV_TOL


# ------------------------------------------- the benchmark's cell, tiny

def _tiny_cell():
    cell = harness.load_cell(CELL)
    cell["config"]["depth"] = 4
    cell["traffic"].update(nx=64, ny=64, batch=2, ring=3, warmup_steps=1,
                           trace_steps=2, reference_rows=2)
    return cell


def _forcing(step, **forced):
    """``step`` with ``forced`` over whatever its caller passes."""
    def broken(*args, **kw):
        return step(*args, **dict(kw, **forced))
    return broken


def _bf16_repulsion(repulsion):
    """The repulsion on bf16 operands, its result rounded to bf16: the
    precision below the configuration's float32."""
    def broken(c):
        return repulsion(c.bfloat16()).bfloat16().float()
    return broken


@pytest.mark.parametrize("fault,check", [
    (None, None), ("no_diversity", "div_gap"),
    ("bf16_diversity", "div_gap"), ("untied", "tie_gap")])
def test_the_cell_judges_its_faults(monkeypatch, fault, check):
    """The new cell's run on the CPU at a tiny size: sound, ``correct``
    with ``tie_gap`` 0; the diversity left out (w1 = 0) or computed in
    bf16 fails ``div_gap`` by 10× or more; an untied decoder fails
    ``tie_gap`` and ``update_gap``."""
    if fault == "no_diversity":
        monkeypatch.setattr(modern, "train_step",
                            _forcing(modern.train_step, w1=0.0))
    elif fault == "untied":
        monkeypatch.setattr(modern, "train_step",
                            _forcing(modern.train_step, sym=False))
    elif fault == "bf16_diversity":
        monkeypatch.setattr(losses, "kernel_repulsion",
                            _bf16_repulsion(losses.kernel_repulsion))
    cell = _tiny_cell()
    out = harness.run(cell, seed=2**31 + 5, seconds=0.2, trace=False,
                      device=torch.device("cpu"), t0=time.perf_counter())
    checks = out["checks"]
    assert list(checks) == ["loss_gap", "grad_gap", "update_gap",
                            "div_gap", "tie_gap"]
    assert out["correct"] is (fault is None)
    if fault is None:
        assert checks["tie_gap"]["value"] == 0.0
        return
    value, limit = checks[check]["value"], checks[check]["limit"]
    assert math.isfinite(value) and value >= 10 * limit
    if fault == "untied":
        assert checks["update_gap"]["value"] \
            >= 10 * checks["update_gap"]["limit"]


# ------------------------------------ the diversity metrics' device time

def _x(name, cat, ts, dur, corr=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _paced_trace():
    """A slice of two steps in which the host paces the card: each
    ``diversity`` span launches two kernels, and the card waits between
    them for the host.  A launch outside the spans (correlation 9) and a
    span of another name are not the objective's."""
    from benchmark import trace as tracing
    return [
        _x(tracing.WINDOW, "user_annotation", 0, 1000),
        _x("diversity", "user_annotation", 100, 50),
        _x("cudaLaunchKernel", "cuda_runtime", 110, 5, corr=1),
        _x("cuLaunchKernelEx", "cuda_driver", 140, 5, corr=2),
        _x("forward", "user_annotation", 200, 50),
        _x("cudaLaunchKernel", "cuda_runtime", 210, 5, corr=9),
        _x("diversity", "user_annotation", 600, 50),
        _x("cudaMemsetAsync", "cuda_runtime", 610, 5, corr=3),
        _x("gemm", "kernel", 120, 10, corr=1),
        _x("gemm", "kernel", 180, 20, corr=2),
        _x("other", "kernel", 220, 300, corr=9),
        _x("fill", "gpu_memset", 620, 4, corr=3),
    ]


def test_launched_s_reads_only_the_work_a_span_launched():
    """The kernels, copies and fills launched inside the spans, by their
    correlation ids: 10 + 20 + 4 µs, not the 84 µs from the first span's
    first kernel to its last, nor the other span's 300."""
    from benchmark.entries import step_tied
    got = step_tied.launched_s(_paced_trace(), ("diversity", "forward"))
    assert got["diversity"] == pytest.approx(34e-6)
    assert got["forward"] == pytest.approx(300e-6)
    assert step_tied.launched_s(_paced_trace(), ("tie",)) == {"tie": 0.0}


def test_diversity_metrics_read_the_launched_time():
    """``diversity_ms_per_step`` is the launched time a step, and
    ``diversity_roofline`` the bound over it; both are left out where the
    slice kept nothing (an untraced run, or a program without the span)."""
    from benchmark.entries import step_tied
    cell = harness.load_cell(CELL)
    ms = harness.load_module("metrics", "diversity_ms_per_step")
    roof = harness.load_module("metrics", "diversity_roofline")
    tr = {"steps": 2,
          "launched_s": step_tied.launched_s(_paced_trace(), ("diversity",))}
    run = {"cell": cell, "trace": tr}
    assert ms.read(run) == pytest.approx(34e-6 * 1e3 / 2)
    t = cell["traffic"]
    assert roof.read(run) == pytest.approx(
        100 * roof.bound_ms(cell["config"], t["nx"], t["ny"]) / ms.read(run))
    for empty in ({"cell": cell, "trace": None},
                  {"cell": cell, "trace": {"steps": 2}},
                  {"cell": cell, "trace": dict(tr, launched_s={
                      "diversity": 0.0})}):
        assert ms.read(empty) is None and roof.read(empty) is None
