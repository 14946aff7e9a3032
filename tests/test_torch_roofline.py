"""The port's roofline cost models (``spectralae_torch.core.roofline``)
against the JAX package's (``spectralae.core.roofline``): the analytic
functions and ``utilization`` exactly, ``device_peaks`` on the H100 names,
and ``op_cost`` against ``compiled_cost`` on a lone matmul, with each
kernel wrapper one opaque call and every loop iteration counted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralae.core import roofline as jrl
from spectralae_torch import _kernels
from spectralae_torch.core import roofline as rl
from spectralae_torch.ops import coord_kernels as ck
from spectralae_torch.ops import spectral
from spectralae_torch.ops import spectral_kernels as sk
from spectralae_torch.ops import window_kernels as wk


@pytest.mark.parametrize("args", [
    (1, 3, 256, 256, 4, 4), (8, 3, 128, 128, 4, 4), (1, 10, 64, 96, 2, 6),
    (2, 1, 2048, 2048, 12, 12)])
@pytest.mark.parametrize("signal_bytes", [4, 2])
def test_anchor_windows_cost(args, signal_bytes):
    assert rl.anchor_windows_cost(*args, signal_bytes=signal_bytes) == \
        jrl.anchor_windows_cost(*args, signal_bytes=signal_bytes)


@pytest.mark.parametrize("args", [
    (3, 10, 5, 5, 100), (3, 50, 5, 5, 100), (3, 10, 13, 13, 400),
    (10, 10, 5, 7, 1)])
def test_corr_iter_flops(args):
    assert rl.corr_iter_flops(*args) == jrl.corr_iter_flops(*args)


@pytest.mark.parametrize("args", [
    (1, 3, 256, 256), (8, 3, 128, 128), (1, 3, 2048, 2048),
    (1, 3, 4096, 4096), (1, 3, 8192, 8192), (2, 3, 64, 256)])
@pytest.mark.parametrize("out_bytes", [4, 2])
@pytest.mark.parametrize("max_m1", [None, 8])
def test_pallas_rfft2_cost(args, out_bytes, max_m1):
    assert rl.pallas_rfft2_cost(*args, out_bytes=out_bytes,
                                max_m1=max_m1) == \
        jrl.pallas_rfft2_cost(*args, out_bytes=out_bytes, max_m1=max_m1)


@pytest.mark.parametrize("args", [
    (8, 3, 10, 256, 256), (1, 3, 50, 128, 64), (4, 10, 10, 512, 512)])
def test_spectral_conv_bytes(args):
    assert rl.spectral_conv_bytes(*args) == jrl.spectral_conv_bytes(*args)


@pytest.mark.parametrize("args", [
    (8, 3, 10, 256, 256, 3), (4, 3, 10, 512, 512, 3), (2, 3, 10, 1024, 1024,
                                                         1)])
def test_fft_step_bytes(args):
    assert rl.fft_step_bytes(*args) == jrl.fft_step_bytes(*args)


@pytest.mark.parametrize("args", [
    (1, 3, 256, 256), (8, 3, 512, 512), (32, 3, 2048, 2048)])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("signal_bytes", [4, 2])
def test_corr_burst_bytes(args, fused, signal_bytes):
    assert rl.corr_burst_bytes(*args, fused=fused,
                               signal_bytes=signal_bytes) == \
        jrl.corr_burst_bytes(*args, fused=fused, signal_bytes=signal_bytes)


@pytest.mark.parametrize("flops,nbytes,seconds", [
    (1.3e9, 2.5e8, 1.7e-3), (None, 4e9, 0.02), (7e12, None, 0.5),
    (None, None, 1.0), (0.0, 0.0, 3e-5)])
@pytest.mark.parametrize("peaks", [None, ("NVIDIA H100 SXM5 80 GB", 989e12,
                                          3.35e12)])
def test_utilization(flops, nbytes, seconds, peaks):
    """Equal to JAX's for the same peaks (each package's Peaks)."""
    mine = rl.Peaks(*peaks) if peaks else None
    theirs = jrl.Peaks(*peaks) if peaks else None
    assert rl.utilization(flops, nbytes, seconds, mine) == \
        jrl.utilization(flops, nbytes, seconds, theirs)


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", ("NVIDIA H100 SXM5 80 GB", 989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", ("NVIDIA H100 PCIe", 756e12, 2.0e12)),
    ("NVIDIA H100 NVL", ("NVIDIA H100 NVL", 835e12, 3.9e12)),
    ("NVIDIA A100-SXM4-80GB", None), ("Some Card", None)])
@pytest.mark.parametrize("device", [None, "cuda", "cuda:0", 0])
def test_device_peaks_names_the_card(monkeypatch, name, want, device):
    """The datasheet peaks by the card's name (torch.cuda patched); None
    for a card the table does not name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    got = rl.device_peaks(device)
    assert got == (rl.Peaks(*want) if want else None)


def test_device_peaks_cpu_and_failures(monkeypatch):
    """None for the CPU, with no CUDA, and where the name cannot be read;
    it never raises."""
    assert rl.device_peaks("cpu") is None
    assert rl.device_peaks(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert rl.device_peaks() is None

    def broken(d=None):
        raise RuntimeError("no CUDA runtime")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", broken)
    assert rl.device_peaks() is None
    assert rl.device_peaks("cuda:0") is None
    assert rl.device_peaks("not a device") is None


def test_op_cost_matmul_equals_compiled_cost():
    """A lone [64, 32] @ [32, 16]: 2·M·N·K flops and the three operands'
    bytes, as XLA's cost analysis counts them."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 32), dtype=np.float32)
    b = rng.standard_normal((32, 16), dtype=np.float32)
    want = jrl.compiled_cost(jax.jit(lambda x, y: x @ y), jnp.asarray(a),
                             jnp.asarray(b))
    got = rl.op_cost(lambda x, y: x @ y, torch.from_numpy(a),
                     torch.from_numpy(b))
    assert got == want == (65536.0, 14336.0)


def _c64(gen, *shape):
    return torch.complex(torch.randn(shape, generator=gen),
                         torch.randn(shape, generator=gen))


def _nbytes(*ts):
    return float(sum(t.numel() * t.element_size() for t in ts))


def test_op_cost_kernel_calls_are_opaque(monkeypatch):
    """K1 and K2 count 0 flops and exactly their operand and result bytes:
    the plain version that runs them on the CPU is not counted."""
    gen = torch.Generator().manual_seed(0)
    p, q = _c64(gen, 8, 3, 129), _c64(gen, 3, 10, 129)
    out = sk.cmul_contract(p, q)
    assert rl.op_cost(sk.cmul_contract, p, q) == (0.0, _nbytes(p, q, out))
    xpad = torch.randn(2, 3, 20, 20, generator=gen)
    w = torch.randn(10, 3, 5, 5, generator=gen)
    y = ck.conv_valid(xpad, w)
    assert rl.op_cost(ck.conv_valid, xpad, w) == (0.0, _nbytes(xpad, w, y))
    # the plain versions do run (their work is not seen)
    seen = []
    plain = sk.cmul_contract_plain
    monkeypatch.setattr(sk, "cmul_contract_plain",
                        lambda *a, **k: seen.append(1) or plain(*a, **k))
    assert rl.op_cost(sk.cmul_contract, p, q)[0] == 0.0
    assert seen == [1]
    assert _kernels.HOOK is None and not _kernels.kernel_route(p)


def test_op_cost_takes_the_kernel_routes_on_the_cpu():
    """While a count runs, spectral_conv takes K1's route on the CPU too
    (0 flops at the kernel, as on the card) instead of the einsum; the
    einsum outside a count is costed as its matmul."""
    gen = torch.Generator().manual_seed(1)
    X, C = _c64(gen, 4, 3, 16, 9), _c64(gen, 10, 3, 16, 9)
    b = torch.randn(10, generator=gen)
    fl, nbytes = rl.op_cost(spectral.spectral_conv, X, C, b, 16, 16)
    assert fl == 0.0 and nbytes > 0
    fl_e, _ = rl.op_cost(spectral.spectral_conv_einsum, X, C, b, 16, 16)
    assert fl_e > 0


def test_op_cost_window_kernel_records_its_call():
    """K3 is one opaque call too; cost_with_kernels adds nothing for it
    and K4's analytic flops for each K4 call."""
    gen = torch.Generator().manual_seed(2)
    X = _c64(gen, 2, 3, 16, 9)
    out = wk.corr_pair_windows(X, X, 16, 16, 2, 2)
    want = (0.0, _nbytes(X, X, out))
    assert rl.op_cost(wk.corr_pair_windows, X, X, 16, 16, 2, 2) == want
    assert rl.cost_with_kernels(wk.corr_pair_windows, X, X, 16, 16, 2,
                                2) == want
    taps = torch.randn(3, 3, 9, 9, generator=gen)
    fl, _ = rl.cost_with_kernels(wk.anchor_windows, X, taps, 16, 16, 4, 4,
                                 0.5)
    assert fl == rl.anchor_windows_cost(2, 3, 16, 16, 4, 4)[0]
    fl2, _ = rl.cost_with_kernels(wk.anchor_windows, X, taps, 16, 16, 4, 4,
                                  0.5, signal_dtype=torch.bfloat16)
    assert fl2 == rl.anchor_windows_cost(2, 3, 16, 16, 4, 4,
                                         signal_bytes=2)[0]


def test_op_cost_counts_every_loop_iteration():
    """An eager 10-iteration loop costs 10× one iteration (no trip-count
    scaling needed)."""
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(32, 32, generator=gen)
    k = torch.randn(32, 32, generator=gen)

    def loop(x, n):
        for _ in range(n):
            x = torch.tanh(x @ k) + x
        return x
    fl1, by1 = rl.op_cost(loop, a, 1)
    fl10, by10 = rl.op_cost(loop, a, 10)
    assert fl1 == 2.0 * 32 ** 3
    assert (fl10, by10) == (10 * fl1, 10 * by1)


def test_op_cost_failure_is_none():
    def boom(x):
        x @ x
        raise ValueError("no")
    assert rl.op_cost(boom, torch.ones(4, 4)) == (None, None)
    assert rl.cost_with_kernels(boom, torch.ones(4, 4)) == (None, None)
    assert _kernels.HOOK is None


@pytest.mark.parametrize("fn,shape,per", [
    (torch.fft.rfft2, (4, 32, 32), 2.5 * 1024 * 10),
    (torch.fft.rfft, (3, 5, 64), 2.5 * 64 * 6),
    (torch.fft.fft2, (2, 16, 16), None),
    (lambda x: torch.fft.irfft2(x, s=(32, 32)), (4, 32, 17), 2.5 * 1024 * 10),
])
def test_op_cost_counts_the_ffts(fn, shape, per):
    """FlopCounterMode has no formula for FFTs: the count adds 5·n·log2 n
    a complex transform of n points and half that a real one, per
    transform of the batch."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=gen)
    if shape[-1] == 17:
        x = torch.fft.rfft2(torch.randn(4, 32, 32, generator=gen))
    if fn is torch.fft.fft2:
        x = torch.complex(x, torch.randn(shape, generator=gen))
        per = 5.0 * 256 * 8
    batch = 1
    for n in shape[:-2 if fn is not torch.fft.rfft else -1]:
        batch *= n
    fl, nbytes = rl.op_cost(fn, x)
    assert fl == per * batch and nbytes > 0
    assert rl.fft_flops("add", (x, x), x) == 0.0
