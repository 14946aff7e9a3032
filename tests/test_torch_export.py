"""The port's ahead-of-time serving artifacts (``torch.export`` ``.pt2``).

Case for case the JAX package's ``tests/test_export.py``, at its small net
(32², one pair of 3→4→3 3×3 stages, weights drawn by JAX and carried over
as numpy arrays, inputs from a numpy seed), at its tolerance (rtol 1e-5,
atol 1e-4) against the JAX package's forward; then the port's own cases:
the kernels' operators in the traced graph, ``torch.library.opcheck`` of
both, the eager forward after an export, a fresh ``serve`` process and
``doctor``.

On the CPU every operator runs its plain version.  Tests marked ``cuda``
trace and serve on the card and need an NVIDIA GPU; they skip without one.
JAX is imported inside the tests that compare with it, so the card-only
tests also run where JAX is not installed::

    python -m pytest tests/test_torch_export.py -m cuda --noconftest
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.cli.main import main as tcli
from spectralae_torch.core.config import Config, LayerParams
from spectralae_torch.core.types import (init_params, initial_spec,
                                         params_from_numpy)
from spectralae_torch.io import checkpoint as tckpt
from spectralae_torch.io.export import ServingModel, export_model
from spectralae_torch.io.server import InferenceServer
from spectralae_torch.model import autoencoder as tmodel
from spectralae_torch.ops import coord_kernels as ck
from spectralae_torch.ops import dft, spectral
from spectralae_torch.ops import resize_kernels as rk
from spectralae_torch.ops import spectral_kernels as sk

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
ROOT = Path(__file__).resolve().parent.parent
CFG = Config(nx=32, ny=32, d=3,
             layer=LayerParams(depth=4, lk=1, ll=1, scale=2, rmax=1.0))
K1_OP, K2_OP = "spectralae_torch.cmul_contract", "spectralae_torch.conv_valid"
RESIZE_OP = "spectralae_torch.spectral_resize"


def _jax():
    """jax.numpy and the JAX package's model module."""
    import jax.numpy as jnp
    from spectralae.model import autoencoder as jmodel
    return jnp, jmodel


@pytest.fixture(scope="module")
def small_net():
    """``tests/test_export.py``'s ``_small_net``: the JAX net, and the same
    weights in the port (``(jparams, spec, params)``)."""
    import jax
    from spectralae.core import config as jconfig
    from spectralae.core import types as jtypes
    jcfg = jconfig.Config(nx=32, ny=32, d=3, layer=jconfig.LayerParams(
        depth=4, lk=1, ll=1, scale=2, rmax=1.0))
    jspec = jtypes.initial_spec(jcfg)
    jparams = jtypes.init_params(jax.random.key(0), jspec, 1.0)
    spec = initial_spec(CFG)
    assert spec.scales == jspec.scales
    params = params_from_numpy([(np.asarray(s.c), np.asarray(s.b))
                                for s in jparams.stages])
    return jparams, spec, params


def _frames(seed: int, batch: int, scale: float = 50.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(batch, 3, 32, 32))
            .astype(np.float32) * scale)


def _jax_fn(jparams, spec, what: str, domain: str, tap_mode="ref_gpu"):
    jnp, jmodel = _jax()
    if what == "forward" and domain == "fft":
        return lambda x: np.asarray(jmodel.forward_fft(jparams, jnp.asarray(x),
                                                       spec.scales))
    if what == "forward":
        return lambda x: np.asarray(jmodel.forward_coord(
            jparams, jnp.asarray(x), spec.scales, tap_mode=tap_mode)[-1])
    return lambda x: np.asarray(jmodel.encode(
        jparams, jnp.asarray(x), spec.scales, domain=domain,
        tap_mode=tap_mode))


def _op_nodes(path: Path, what: str = "forward") -> list[str]:
    program = torch.export.load(path / f"{what}.pt2")
    return [str(n.target).removesuffix(".default")
            for n in program.graph.nodes
            if n.op == "call_function"
            and str(n.target).startswith("spectralae_torch.")]


# -- the JAX package's cases ----------------------------------------------

@pytest.mark.parametrize("what,domain", [("forward", "fft"),
                                         ("forward", "coord"),
                                         ("encode", "fft")])
def test_export_roundtrip_matches_direct(small_net, tmp_path, what, domain):
    jparams, spec, params = small_net
    path = export_model(params, spec, tmp_path / "art", what=what,
                        domain=domain, batch=2)
    assert (path / f"{what}.pt2").exists()
    x = _frames(0, 2)
    got = ServingModel.load(path, device="cpu")(x)
    np.testing.assert_allclose(got, _jax_fn(jparams, spec, what, domain)(x),
                               rtol=RTOL, atol=ATOL)


def test_export_coord_tap_mode_recorded_and_overridable(small_net, tmp_path):
    jparams, spec, params = small_net
    x = _frames(1, 1)
    m = ServingModel.load(export_model(params, spec, tmp_path / "gpu",
                                       what="forward", domain="coord",
                                       batch=1), device="cpu")
    assert m.manifest["tap_mode"] == "ref_gpu"
    np.testing.assert_allclose(
        m(x), _jax_fn(jparams, spec, "forward", "coord")(x),
        rtol=RTOL, atol=ATOL)
    m2 = ServingModel.load(export_model(params, spec, tmp_path / "cen",
                                        what="forward", domain="coord",
                                        batch=1, tap_mode="centered"),
                           device="cpu")
    assert m2.manifest["tap_mode"] == "centered"
    np.testing.assert_allclose(
        m2(x), _jax_fn(jparams, spec, "forward", "coord", "centered")(x),
        rtol=RTOL, atol=ATOL)
    # the two windows genuinely differ
    assert not np.allclose(m(x), m2(x), rtol=1e-3, atol=1e-2)


def test_export_symbolic_batch_serves_any_batch(small_net, tmp_path):
    jparams, spec, params = small_net
    m = ServingModel.load(export_model(params, spec, tmp_path / "art",
                                       batch=None), device="cpu")
    assert m.manifest["batch"] is None
    want = _jax_fn(jparams, spec, "forward", "fft")
    for b in (1, 3, 5):
        x = _frames(b, b, 1.0)
        np.testing.assert_allclose(m(x), want(x), rtol=RTOL, atol=ATOL)


def test_export_fixed_batch_rejects_other_batch(small_net, tmp_path):
    _, spec, params = small_net
    m = ServingModel.load(export_model(params, spec, tmp_path / "art",
                                       batch=2), device="cpu")
    with pytest.raises(ValueError, match="batch=2"):
        m(np.zeros((3, 3, 32, 32), np.float32))
    with pytest.raises(ValueError, match="expected input"):
        m(np.zeros((2, 3, 16, 16), np.float32))


def test_export_multiplatform_artifact(small_net, tmp_path):
    """An artifact for both platforms is recorded as such and loads on the
    CPU; one for the CPU alone is refused on the card before any device
    work (so the refusal shows here, without a card)."""
    jparams, spec, params = small_net
    path = export_model(params, spec, tmp_path / "both", batch=1,
                        platforms=("cpu", "cuda"))
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["platforms"] == ["cpu", "cuda"]
    assert manifest["format_version"] == 2
    x = np.ones((1, 3, 32, 32), np.float32)
    np.testing.assert_allclose(ServingModel.load(path, device="cpu")(x),
                               _jax_fn(jparams, spec, "forward", "fft")(x),
                               rtol=RTOL, atol=ATOL)
    cpu_only = export_model(params, spec, tmp_path / "cpu", batch=1,
                            platforms=("cpu",))
    with pytest.raises(ValueError, match="platforms"):
        ServingModel.load(cpu_only, device="cuda")
    with pytest.raises(ValueError, match="platforms"):
        export_model(params, spec, tmp_path / "tpu", platforms=("cpu",
                                                                "tpu"))


def test_cli_export_serve_and_eval(small_net, tmp_path, capsys):
    _, spec, params = small_net
    ck_dir = tmp_path / "ck"
    tckpt.save(ck_dir, params, spec)
    art = tmp_path / "art"
    tcli(["export", "--from-ckpt", str(ck_dir), "--out", str(art),
          "--what", "both", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "exported forward" in out and "exported encode" in out
    assert (art / "forward" / "forward.pt2").exists()
    assert (art / "encode" / "encode.pt2").exists()
    assert not (art / "forward" / "weights.npz").exists()
    # serving from the root resolves the forward artifact...
    tcli(["serve", "--model", str(art), "--device", "cpu", "--steps", "2",
          "--batch", "2", "--outdir", str(tmp_path / "views"),
          "--dump-every", "1"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 4 and rec["what"] == "forward"
    assert rec["platforms"] == ["cpu"]
    assert (tmp_path / "views" / "serve_00000.png").exists()
    # ...and the encode artifact is addressable by its subdirectory
    tcli(["serve", "--model", str(art / "encode"), "--device", "cpu",
          "--steps", "1", "--batch", "1", "--outdir",
          str(tmp_path / "views2")])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["what"] == "encode"
    # eval of the artifact agrees with eval of its checkpoint
    tcli(["eval", "--from-ckpt", str(ck_dir), "--device", "cpu",
          "--steps", "2", "--batch", "2"])
    tcli(["eval", "--model", str(art / "forward"), "--device", "cpu",
          "--steps", "2", "--batch", "2"])
    a, b = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()[-2:]]
    assert a["frames"] == b["frames"] == 4
    assert abs(a["mse_per_pixel"] - b["mse_per_pixel"]) <= \
        1e-5 * a["mse_per_pixel"]
    # platforms outside cpu and cuda are refused
    with pytest.raises(SystemExit):
        tcli(["export", "--out", str(tmp_path / "x"), "--device", "cpu",
              "--platforms", "cpu,tpu"])


def test_http_dynamic_batching_on_a_pt2(small_net, tmp_path):
    """Concurrent /infer requests within the window share model calls on a
    symbolic-batch artifact, and each gets its own slice."""
    jparams, spec, params = small_net
    inner = ServingModel.load(export_model(params, spec, tmp_path / "art",
                                           batch=None), device="cpu")
    calls = []

    class Counting:
        manifest, input_shape = inner.manifest, inner.input_shape

        def __call__(self, x):
            calls.append(x.shape[0])
            return inner(x)

    srv = InferenceServer(Counting(), port=0, batch_window_ms=300,
                          warmup=True)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    xs = [_frames(10 + i, 1) for i in range(4)]
    outs = [None] * 4

    def post(i):
        buf = io.BytesIO()
        np.save(buf, xs[i])
        req = urllib.request.Request(base + "/infer", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            outs[i] = np.load(io.BytesIO(r.read()), allow_pickle=False)
    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.shutdown()
    want = _jax_fn(jparams, spec, "forward", "fft")
    for x, out in zip(xs, outs):
        np.testing.assert_allclose(out, want(x), rtol=RTOL, atol=ATOL)
    # the warm-up call, then the four frames in fewer than four calls
    assert calls[0] == 1 and sum(calls[1:]) == 4 and len(calls) < 6


# -- the port's own cases ---------------------------------------------------

@pytest.mark.parametrize("what,domain,op", [
    ("forward", "fft", K1_OP), ("encode", "fft", K1_OP),
    ("forward", "coord", K2_OP), ("encode", "coord", K2_OP)])
def test_traced_graph_holds_the_kernel_operators(small_net, tmp_path, what,
                                                 domain, op):
    """One node per stage: K1 in every fft stage, K2 in every coord stage
    of a K2 kernel shape (M·D ≤ 64, 3×3 taps), on a CPU trace too; and one
    resize node a spectral pooling, before an encoder stage's K1 and after
    a decoder stage's."""
    _, spec, params = small_net
    path = export_model(params, spec, tmp_path, what=what, domain=domain)
    stages = params.n_stages if what == "forward" else params.n_stages // 2
    want = []
    for i, scale in enumerate(spec.scales[:stages]):
        pool = [RESIZE_OP] if domain == "fft" and abs(scale) > 1 else []
        want += pool + [op] if i < params.n_stages // 2 else [op] + pool
    assert RESIZE_OP in want or domain == "coord"
    assert _op_nodes(path, what) == want


def _cplx(gen, *shape):
    return torch.complex(torch.randn(shape, generator=gen),
                         torch.randn(shape, generator=gen))


def _opcheck_cases():
    gen = torch.Generator().manual_seed(0)
    p, C = _cplx(gen, 2, 3, 40), _cplx(gen, 4, 3, 40)
    bias = torch.randn(4, generator=gen)
    x = torch.randn(2, 3, 20, 18, generator=gen)
    w = torch.randn(4, 3, 5, 5, generator=gen)
    return {
        "k1": (sk.cmul_contract_op, (p, C.transpose(0, 1), 0.25, False,
                                     None, 0.0)),
        "k1_conj_bias": (sk.cmul_contract_op, (p, C.transpose(0, 1), 0.25,
                                               True, bias, 64.0)),
        "k1_bf16": (sk.cmul_contract_op, (
            sk.bf16_planes(p, 0.25), sk.bf16_planes(C).transpose(0, 1), 1.0,
            False, bias, 64.0)),
        "k1_bf16_conj": (sk.cmul_contract_op, (
            sk.bf16_planes(p), sk.bf16_planes(C.transpose(0, 1)), 0.5, True,
            None, 0.0)),
        "k2": (ck.conv_valid_op, (x, w)),
        "k2_bf16": (ck.conv_valid_op, (x.bfloat16().float(),
                                       w.bfloat16().float())),
        "resize_crop": (rk.spectral_resize_op, (_cplx(gen, 2, 3, 18, 10),
                                                18, 18, 9, 9, False)),
        "resize_crop_adjoint": (rk.spectral_resize_op, (
            _cplx(gen, 2, 3, 9, 5), 18, 18, 9, 9, True)),
        "resize_pad": (rk.spectral_resize_op, (_cplx(gen, 3, 9, 5),
                                               9, 9, 18, 18, False)),
    }


@pytest.mark.parametrize("case", list(_opcheck_cases()))
def test_opcheck_passes_on_the_cpu(case):
    op, args = _opcheck_cases()[case]
    assert set(torch.library.opcheck(op, args).values()) == {"SUCCESS"}


@pytest.mark.parametrize("kernel", ["k1", "k2", "resize"])
def test_operator_only_while_tracing(kernel, monkeypatch):
    """Eager code calls the operator's kernel for the device directly,
    without the dispatcher; a graph that ``torch.compile`` traces holds
    the operator as one node, and runs it to the same result."""
    gen = torch.Generator().manual_seed(1)
    if kernel == "k1":
        call, op = sk._cmul_contract, sk.cmul_contract_op
        args = (_cplx(gen, 2, 3, 40), _cplx(gen, 3, 4, 40))

        def fn(p, q):
            return sk.cmul_contract(p, q, p_scale=0.5, conj_q=True)
    elif kernel == "resize":
        call, op = rk._spectral_resize, rk.spectral_resize_op
        args = (_cplx(gen, 2, 3, 16, 9),)

        def fn(X):
            return rk.spectral_resize(X, 16, 16, 8, 8)
    else:
        call, op = ck._conv_valid, ck.conv_valid_op
        args = (torch.randn(2, 3, 12, 10, generator=gen),
                torch.randn(4, 3, 5, 5, generator=gen))
        fn = ck._valid_corr
    assert call.op is op
    kernels = dict(call.kernels)
    calls = []

    def counted(*a):
        calls.append(a)
        return kernels["cpu"](*a)
    monkeypatch.setitem(call.kernels, "cpu", counted)
    want = fn(*args)
    assert len(calls) == 1          # through the table, not the operator

    graphs = []

    def record(gm, example_inputs):
        graphs.append([n.target for n in gm.graph.nodes
                       if n.op == "call_function"])
        return gm.forward
    torch._dynamo.reset()
    got = torch.compile(fn, backend=record, fullgraph=True)(*args)
    assert len(calls) == 1          # the graph called the operator
    assert graphs == [[op._opoverload]]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_eager_forward_after_an_export_still_matches_jax(small_net,
                                                         tmp_path):
    """The traced forward must leave no fake tensor behind in a cache that
    the eager forward reads (the resize maps, the DFT bases): after
    exports in both domains, the eager forwards in this process equal
    JAX's."""
    jparams, spec, params = small_net
    # empty, so that the traces are the first to ask for these tensors
    spectral._resize_tensors.cache_clear()
    dft._bases_on.cache_clear()
    dft._spectrum_bases_on.cache_clear()
    for domain in ("fft", "coord"):
        export_model(params, spec, tmp_path / domain, domain=domain,
                     batch=None)
    x = _frames(7, 2)
    got = tmodel.forward_fft(params, torch.from_numpy(x), spec.scales)
    assert type(got) is torch.Tensor
    np.testing.assert_allclose(got.numpy(),
                               _jax_fn(jparams, spec, "forward", "fft")(x),
                               rtol=RTOL, atol=ATOL)
    got = tmodel.forward_coord(params, torch.from_numpy(x), spec.scales,
                               tap_mode="ref_gpu")[-1]
    np.testing.assert_allclose(
        got.numpy(), _jax_fn(jparams, spec, "forward", "coord")(x),
        rtol=RTOL, atol=ATOL)


def test_tensor_cache_keeps_no_tensor_made_under_a_trace():
    """A trace that is the first to ask for the DFT bases (no eager call
    before it) builds them afresh and stores nothing: the next eager call
    gets real tensors.  ``export_model`` fills the caches first, so its
    programs hold each as one constant, with no copy made at every call.
    The resize's maps (``spectral._resize_tensors``, the CUDA kernel's
    ``resize_kernels._row_map``) are built only by the resize operator's
    real kernels, never under the trace, which reaches the operator's
    fake: the program's first call on the CPU builds them, real."""
    spectral._resize_tensors.cache_clear()
    rk._row_map.cache_clear()
    dft._bases_on.cache_clear()
    dft._spectrum_bases_on.cache_clear()
    built = []

    class Pool(torch.nn.Module):
        def forward(self, x):
            X, _, _ = spectral.spectral_pool(torch.fft.rfft2(x), 16, 16, 2)
            return X * dft.kernel_spectrum(torch.ones(3, 3), 8, 8)

    x = torch.randn(2, 16, 16)
    maps = spectral._resize_tensors
    spectral._resize_tensors = lambda *a: built.append(a) or maps(*a)
    try:
        with torch.no_grad():
            program = torch.export.export(Pool(), (x,))
        assert not built
        got = program.module()(x)
    finally:
        spectral._resize_tensors = maps
    assert built == [(16, 16, 8, 8, x.device, False)]
    rows = spectral._resize_tensors(16, 16, 8, 8, x.device, False)[0]
    bases = dft._spectrum_bases_on(3, 3, 8, 8, x.device)
    assert type(rows) is torch.Tensor
    assert all(type(b) is torch.Tensor for b in bases)
    assert rows.tolist() == [0, 1, 2, 3, 8, 13, 14, 15]
    assert torch.equal(got, Pool()(x))
    row_map = rk._row_map(16, 16, 8, 8, True, x.device)
    assert type(row_map) is torch.Tensor
    assert row_map.tolist() == [0, 1, 2, 3, -1, -1, -1, -1, 4, -1, -1, -1,
                                -1, 5, 6, 7]


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_exported_constants_are_not_copied_per_call(small_net, tmp_path,
                                                    domain):
    _, spec, params = small_net
    program = torch.export.load(export_model(params, spec, tmp_path,
                                             domain=domain) / "forward.pt2")
    targets = {str(n.target) for n in program.graph.nodes}
    assert not targets & {"aten.lift_fresh_copy.default", "aten.to.device"}


def test_format_1_artifact_is_refused_naming_re_export(small_net, tmp_path):
    _, spec, params = small_net
    path = export_model(params, spec, tmp_path)
    manifest = json.loads((path / "manifest.json").read_text())
    manifest["format_version"] = 1
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="re-export"):
        ServingModel.load(path, device="cpu")


def _subprocess_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_pt2_serves_in_a_fresh_process(small_net, tmp_path):
    """A new interpreter that imports nothing but the CLI loads the program
    and serves it: loading registers the operators its graph calls."""
    _, spec, params = small_net
    for domain in ("fft", "coord"):
        export_model(params, spec, tmp_path / domain, domain=domain)
        r = subprocess.run(
            [sys.executable, "-m", "spectralae_torch.cli.main", "serve",
             "--model", str(tmp_path / domain), "--device", "cpu",
             "--steps", "2", "--batch", "2", "--outdir",
             str(tmp_path / "views")],
            cwd=tmp_path, env=_subprocess_env(), capture_output=True,
            text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        assert rec["frames"] == 4 and rec["what"] == "forward"


def test_doctor_without_a_device_reports_and_exits_0(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "spectralae_torch.cli.main", "doctor",
         "--no-device", "--device-timeout", "30"],
        cwd=tmp_path, env=_subprocess_env(), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr
    info = json.loads(r.stdout)
    assert {"torch", "numpy", "cuda_runtime", "opencv", "native_lib",
            "cuda", "nvidia_smi", "kernel_build"} <= set(info)
    assert set(info["native_lib"]) == {"available", "batch_stage",
                                       "yuv_decode", "png_unfilter"}
    assert info["torch"] == torch.__version__
    assert "device_check" not in info
    if not torch.cuda.is_available():
        assert info["cuda"] is False


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_pt2_on_the_card_equals_eager_and_launches(cuda_device, tmp_path,
                                                   domain):
    """A symbolic-batch artifact traced and served on the card equals the
    eager forward on the card, and each call launches each kernel once per
    operator node (K1 and the resize in the fft domain, K2 in the
    coord)."""
    spec = initial_spec(CFG)
    params = init_params(torch.Generator().manual_seed(0), spec, 1.0)
    params = params.from_leaves([t.to(cuda_device) for t in params.leaves()])
    path = export_model(params, spec, tmp_path, domain=domain)
    nodes = _op_nodes(path)
    m = ServingModel.load(path, device=cuda_device)
    x = torch.from_numpy(_frames(3, 3)).to(cuda_device)
    counters = ({K1_OP: sk.k1_launches,
                 RESIZE_OP: lambda: _kernels.LAUNCHES["spectral_resize"]}
                if domain == "fft"
                else {K2_OP: lambda: _kernels.LAUNCHES["conv_valid"]})
    assert set(nodes) == set(counters)
    before = {op: c() for op, c in counters.items()}
    got = m(x)
    torch.cuda.synchronize()
    for op, c in counters.items():
        assert c() - before[op] == nodes.count(op) > 0
    with torch.no_grad():
        if domain == "fft":
            want = tmodel.forward_fft(params, x, spec.scales)
        else:
            want = tmodel.forward_coord(params, x, spec.scales,
                                        tap_mode="ref_gpu")[-1]
    err = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    assert err < 1e-6
