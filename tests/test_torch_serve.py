"""The port's serving path on the CPU: checkpoints, export, HTTP, CLI, data.

Weights are drawn by numpy and carried between the frameworks as numpy
arrays.  Tolerance: norm-relative 1e-5 for whole forwards (float32 chains
through FFTs and convs, two libraries); file formats and codecs are exact.
"""

import io
import itertools
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spectralae.core import types as jtypes
from spectralae.core.config import Config, LayerParams
from spectralae.data import pipeline as jpipe
from spectralae.io import checkpoint as jckpt
from spectralae.model import autoencoder as jmodel
from spectralae_torch.cli import main as tcli
from spectralae_torch.data import pipeline as tpipe
from spectralae_torch.io import checkpoint as tckpt
from spectralae_torch.io.export import ServingModel, export_model
from spectralae_torch.io.server import InferenceServer
from spectralae_torch.model import autoencoder as tmodel

torch.set_num_threads(1)

CHAIN_TOL = 1e-5
CFG = Config(nx=32, ny=32, d=3, layer=LayerParams(depth=4))


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def jax_net():
    """A 2-pair JAX net with numpy-drawn weights, and a batch of frames."""
    spec = jtypes.initial_spec(CFG).add_pair(CFG.layer)
    rng = np.random.default_rng(0)
    params = jtypes.AEParams(stages=tuple(
        jtypes.ConvStage(
            c=jnp.asarray(rng.uniform(-3, 3, (s.m, s.d, s.nk, s.nl))
                          .astype(np.float32)),
            b=jnp.asarray(rng.uniform(-3, 3, s.m).astype(np.float32)))
        for s in spec.stages))
    x = rng.uniform(0, 255, (3, 3, 32, 32)).astype(np.float32)
    return params, spec, x


@pytest.fixture(scope="module")
def port_net(jax_net, tmp_path_factory):
    """The same net, loaded by the port from a JAX checkpoint."""
    params, spec, _ = jax_net
    path = tmp_path_factory.mktemp("ckpt")
    jckpt.save(path, params, spec)
    return tckpt.load(path)


def test_jax_checkpoint_loads_in_port_with_an_equal_forward(jax_net,
                                                             port_net):
    jparams, jspec, x = jax_net
    tparams, tspec, opt, extra = port_net
    assert tspec.scales == jspec.scales
    assert (tspec.nx, tspec.ny, tspec.d) == (jspec.nx, jspec.ny, jspec.d)
    assert opt is None and extra == {}
    for t, j in zip(tparams.stages, jparams.stages):
        np.testing.assert_array_equal(t.c.numpy(), np.asarray(j.c))
        np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))
    got = tmodel.forward_fft(tparams, torch.from_numpy(x), tspec.scales)
    want = jmodel.forward_fft(jparams, jnp.asarray(x), jspec.scales)
    assert rel(got, want) < CHAIN_TOL


def test_port_checkpoint_loads_in_jax(port_net, tmp_path):
    tparams, tspec, _, _ = port_net
    tckpt.save(tmp_path, tparams, tspec, extra={"step": 7})
    jparams, jspec, opt, extra = jckpt.load(tmp_path)
    assert opt is None and extra == {"step": 7}
    assert jspec.scales == tspec.scales
    for t, j in zip(tparams.stages, jparams.stages):
        np.testing.assert_array_equal(np.asarray(j.c), t.c.numpy())


def test_checkpoint_shape_mismatch_fails_loudly(port_net, tmp_path):
    tparams, tspec, _, _ = port_net
    tckpt.save(tmp_path, tparams, tspec)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    manifest["shapes"]["stage0/c"] = [1, 1, 1, 1]
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load(tmp_path)


@pytest.mark.parametrize("what,domain,tap", [
    ("forward", "fft", None), ("encode", "fft", None),
    ("forward", "coord", None), ("encode", "coord", "ref_cpu"),
    ("forward", "coord", "centered")])
def test_exported_model_matches_jax(jax_net, port_net, tmp_path, what,
                                    domain, tap):
    jparams, jspec, x = jax_net
    tparams, tspec, _, _ = port_net
    export_model(tparams, tspec, tmp_path, what=what, domain=domain,
                 tap_mode=tap)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert set(manifest) == {"format_version", "what", "domain", "tap_mode",
                             "batch", "dtype", "input_shape", "platforms",
                             "spec", "extra"}
    assert manifest["platforms"] == ["cpu"]     # the device traced on
    assert manifest["tap_mode"] == (tap or "ref_gpu")
    model = ServingModel.load(tmp_path, device="cpu")
    got = model(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    tap = tap or "ref_gpu"
    if what == "encode":
        want = jmodel.encode(jparams, jnp.asarray(x), jspec.scales,
                             domain=domain, tap_mode=tap)
    elif domain == "fft":
        want = jmodel.forward_fft(jparams, jnp.asarray(x), jspec.scales)
    else:
        want = jmodel.forward_coord(jparams, jnp.asarray(x), jspec.scales,
                                    tap_mode=tap)[-1]
    assert got.shape == want.shape
    assert rel(got, want) < CHAIN_TOL
    # a tensor in gives a tensor out, on the model's device
    out_t = model(torch.from_numpy(x))
    assert isinstance(out_t, torch.Tensor) and out_t.device.type == "cpu"
    np.testing.assert_array_equal(out_t.numpy(), got)


def test_serving_model_checks_shape_and_batch(port_net, tmp_path):
    tparams, tspec, _, _ = port_net
    export_model(tparams, tspec, tmp_path / "forward", batch=2)
    model = ServingModel.load(tmp_path, device="cpu")   # 'both'-style root
    with pytest.raises(ValueError, match="expected input"):
        model(np.zeros((2, 3, 16, 32), np.float32))
    with pytest.raises(ValueError, match="batch=2"):
        model(np.zeros((3, 3, 32, 32), np.float32))
    assert model(np.zeros((2, 3, 32, 32), np.float32)).shape == (2, 3, 32,
                                                                 32)


def _post(url: str, arr: np.ndarray):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()))


@pytest.mark.parametrize("batch_ms", [0.0, 5.0])
def test_http_server_serves_the_port(jax_net, port_net, tmp_path, batch_ms):
    jparams, jspec, x = jax_net
    tparams, tspec, _, _ = port_net
    export_model(tparams, tspec, tmp_path, what="forward", domain="fft")
    srv = InferenceServer(ServingModel.load(tmp_path, device="cpu"), port=0,
                          warmup=True, batch_window_ms=batch_ms)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["input_shape"] == [3, 32,
                                                                       32]
        want = np.asarray(jmodel.forward_fft(jparams, jnp.asarray(x),
                                             jspec.scales))
        assert rel(_post(base + "/infer", x), want) < CHAIN_TOL
        one = _post(base + "/infer", x[0])            # a single frame
        assert one.shape == (3, 32, 32)
        assert rel(one, want[0]) < CHAIN_TOL
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(base + "/infer", np.zeros((1, 3, 8, 8), np.float32))
        assert bad.value.code == 400
    finally:
        srv.shutdown()


def test_cli_info_export_and_serve(tmp_path, capsys):
    from spectralae.cli import main as jcli
    tcli.main(["info", "--nx", "64", "--layers", "3"])
    got = capsys.readouterr().out
    jcli.cmd_info(jcli.argparse.Namespace(nx=64, ny=None, depth=3, seed=0,
                                          param_file=None, layers=3))
    assert got == capsys.readouterr().out
    tcli.main(["export", "--nx", "32", "--layers", "2", "--seed", "3",
               "--out", str(tmp_path / "art"), "--what", "both",
               "--domain", "coord", "--device", "cpu"])
    assert (tmp_path / "art" / "forward" / "forward.pt2").exists()
    assert (tmp_path / "art" / "encode" / "manifest.json").exists()
    capsys.readouterr()
    tcli.main(["serve", "--model", str(tmp_path / "art" / "encode"),
               "--device", "cpu", "--steps", "2", "--batch", "2",
               "--dump-every", "1", "--outdir", str(tmp_path / "views")])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 4 and rec["what"] == "encode"
    assert rec["device"] == "cpu"
    assert sorted(p.name for p in (tmp_path / "views").iterdir()) == [
        "serve_00000.png", "serve_00001.png"]
    with pytest.raises(SystemExit):
        tcli.main(["export", "--out", str(tmp_path / "x"), "--platforms",
                   "cpu,tpu"])


def test_fresh_cli_net_is_seeded():
    ns = tcli.argparse.Namespace(nx=32, ny=None, depth=3, seed=4,
                                 param_file=None, layers=2)
    a, spec = tcli._make_net(ns)
    b, _ = tcli._make_net(ns)
    assert spec.n_pairs == 2 and spec.scales == (2, 2, -2, -2)
    for sa, sb in zip(a.stages, b.stages):
        assert torch.equal(sa.c, sb.c)
        assert float(sa.c.abs().max()) <= 3.0


def test_codecs_and_sources_match_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (20, 12, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tpipe.frame_to_tensor(img),
                                  jpipe.frame_to_tensor(img))
    spin = rng.normal(128, 90, (3, 12, 20)).astype(np.float32)
    np.testing.assert_array_equal(tpipe.tensor_to_frame(spin),
                                  jpipe.tensor_to_frame(spin))
    np.testing.assert_array_equal(tpipe.feature_to_image(spin[0] * 3),
                                  jpipe.feature_to_image(spin[0] * 3))
    np.testing.assert_array_equal(tpipe.resize_nn(img, 7, 9),
                                  jpipe.resize_nn(img, 7, 9))
    for a, b in zip(itertools.islice(tpipe.synthetic_frames(16, 8, seed=2),
                                     3),
                    itertools.islice(jpipe.synthetic_frames(16, 8, seed=2),
                                     3)):
        np.testing.assert_array_equal(a, b)


def test_prefetcher_batches_on_the_cpu():
    frames = list(itertools.islice(tpipe.synthetic_frames(12, 10, seed=1),
                                   5))
    pf = tpipe.DevicePrefetcher(iter(frames), 8, 6, batch=2, device="cpu")
    got = list(pf)
    pf.close()
    assert [b.shape[0] for b in got] == [2, 2, 1]    # partial batch kept
    want = np.stack([tpipe.frame_to_tensor(tpipe.resize_nn(f, 8, 6))
                     for f in frames])
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    assert got[0].dtype == torch.float32 and got[0].shape[1:] == (3, 8, 6)
