"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper runs its kernel's plain PyTorch version, and the
JAX kernels run in Pallas interpret mode (``_on_tpu()`` is false), as the
JAX package's own tests run them.  Tolerance: norm-relative 1e-6 — the same
float32 products, summed in another order.

Tests marked ``cuda`` launch the hand-written kernels and need an NVIDIA
GPU; they skip without one.  JAX is imported inside the tests that compare
with it, so that the card-only tests also run where JAX is not installed::

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.ops import coord_kernels as ck
from spectralae_torch.ops import spectral_kernels as sk

torch.set_num_threads(1)

TOL = 1e-6


def rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def cplx(rng, *shape):
    return (rng.normal(size=shape)
            + 1j * rng.normal(size=shape)).astype(np.complex64)


def _jax():
    """jax.numpy and the JAX package's Pallas kernel modules."""
    import jax.numpy as jnp
    from spectralae.ops import pallas_conv, pallas_kernels
    return jnp, pallas_kernels, pallas_conv


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("a,k,b,w", [(2, 3, 5, 40), (1, 4, 1, 7),
                                     (3, 2, 17, 33)])
def test_cmul_contract_matches_pallas(a, k, b, w):
    jnp, jpk, _ = _jax()
    rng = np.random.default_rng(0)
    p, q = cplx(rng, a, k, w), cplx(rng, k, b, w)
    before = sk.LAUNCHES
    got = sk.cmul_contract(torch.from_numpy(p), torch.from_numpy(q))
    assert sk.LAUNCHES == before     # the CPU takes the plain version
    wr, wi = jpk._cmul_contract(jnp.asarray(p.real), jnp.asarray(p.imag),
                                jnp.asarray(q.real), jnp.asarray(q.imag),
                                interpret=True)
    assert rel(got, np.asarray(wr) + 1j * np.asarray(wi)) < TOL


def test_cmul_contract_fuses_scale_and_dc_bias():
    rng = np.random.default_rng(1)
    p, q = cplx(rng, 2, 3, 20), cplx(rng, 3, 4, 20)
    bias = rng.normal(size=4).astype(np.float32)
    got = sk.cmul_contract(torch.from_numpy(p), torch.from_numpy(q),
                           p_scale=0.25, bias=torch.from_numpy(bias),
                           bias_scale=64.0).numpy()
    want = np.einsum("akw,kbw->abw", p.astype(np.complex128) * 0.25, q)
    want[:, :, 0] += bias * 64.0
    assert rel(got, want) < TOL


@pytest.mark.parametrize("nx,ny,m,d,nb", [(16, 16, 4, 3, 2), (12, 10, 3, 5, 1)])
def test_spectral_conv_fused_matches_pallas(nx, ny, m, d, nb):
    jnp, jpk, _ = _jax()
    rng = np.random.default_rng(2)
    X = np.fft.rfft2(rng.normal(size=(nb, d, nx, ny))).astype(np.complex64)
    C = np.fft.rfft2(rng.normal(size=(m, d, nx, ny))).astype(np.complex64)
    b = rng.normal(size=m).astype(np.float32)
    got = sk.spectral_conv_fused(torch.from_numpy(X), torch.from_numpy(C),
                                 torch.from_numpy(b), nx, ny)
    want = jpk.spectral_conv_fused(jnp.asarray(X), jnp.asarray(C),
                                   jnp.asarray(b), nx, ny)
    assert got.shape == (nb, m, nx, ny // 2 + 1)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("scale_by_dm", [True, False])
def test_spectral_conv_pallas_matches_pallas(scale_by_dm):
    jnp, jpk, _ = _jax()
    rng = np.random.default_rng(3)
    nx = ny = 16
    X = np.fft.rfft2(rng.normal(size=(3, nx, ny))).astype(np.complex64)
    C = np.fft.rfft2(rng.normal(size=(4, 3, nx, ny))).astype(np.complex64)
    b = rng.normal(size=4).astype(np.float32)
    got = sk.spectral_conv_pallas(torch.from_numpy(X), torch.from_numpy(C),
                                  torch.from_numpy(b), nx, ny,
                                  scale_by_dm=scale_by_dm)
    want = jpk.spectral_conv_pallas(jnp.asarray(X), jnp.asarray(C),
                                    jnp.asarray(b), nx, ny,
                                    scale_by_dm=scale_by_dm, interpret=True)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("shape", [(2, 3, 4, 12, 12, 5, 5),
                                   (1, 2, 3, 9, 14, 3, 3)])
def test_conv_valid_matches_pallas(shape):
    jnp, _, jconv = _jax()
    b, d, m, h, w, nk, nl = shape
    rng = np.random.default_rng(4)
    xpad = rng.normal(size=(b, d, h + nk - 1, w + nl - 1)).astype(np.float32)
    wt = rng.normal(size=(m, d, nk, nl)).astype(np.float32)
    before = ck.LAUNCHES
    got = ck.conv_valid(torch.from_numpy(xpad), torch.from_numpy(wt))
    assert ck.LAUNCHES == before     # the CPU takes the plain version
    want = jconv.conv_valid_pallas(jnp.asarray(xpad), jnp.asarray(wt))
    assert got.shape == (b, m, h, w)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "bias"])
def test_cmul_contract_rejects_what_the_kernel_does_not_take(case):
    p = torch.zeros(2, 3, 8, dtype=torch.complex64)
    q = torch.zeros(3, 4, 8, dtype=torch.complex64)
    bias = None
    if case == "dtype":
        p = p.to(torch.complex128)
    elif case == "shape":
        q = q[:2]
    elif case == "device":
        p, q = p.to("meta"), q.to("meta")   # neither cpu nor cuda
    else:
        bias = torch.zeros(5)
    with pytest.raises((TypeError, ValueError)):
        sk.cmul_contract(p, q, bias=bias)


@pytest.mark.parametrize("case", ["dtype", "channels", "small", "device"])
def test_conv_valid_rejects_what_the_kernel_does_not_take(case):
    xpad = torch.zeros(1, 2, 10, 10)
    w = torch.zeros(3, 2, 5, 5)
    if case == "dtype":
        xpad = xpad.double()
    elif case == "channels":
        w = torch.zeros(3, 4, 5, 5)
    elif case == "small":
        xpad = torch.zeros(1, 2, 4, 10)
    else:
        xpad, w = xpad.to("meta"), w.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ck.conv_valid(xpad, w)


def test_fused_conv_reduced_precision_raises():
    """bf16 operands are K1's bf16 mode; any other reduced type raises."""
    X = torch.zeros(1, 2, 8, 5, dtype=torch.complex64)
    C = torch.zeros(3, 2, 8, 5, dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="bf16 operands only"):
        sk.spectral_conv_fused(X, C, torch.zeros(3), 8, 8,
                               compute_dtype=torch.float16)


def test_kernel_build_is_keyed_by_sources_and_targets_hopper():
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    names = {s.name for s in _kernels._sources()}
    assert {"cmul_contract.cu", "conv_valid.cu"} <= names
    assert len(_kernels._digest()) == 16
    # the build lands in a directory git ignores
    assert _kernels.BUILD_DIR.parts[-2:] == ("build", "spectralae_torch")


@pytest.mark.cuda
@pytest.mark.parametrize("a,k,b,n", [(8, 3, 10, 128), (8, 10, 10, 64),
                                     (8, 10, 3, 128), (2, 3, 20, 16)])
def test_cmul_contract_kernel_matches_plain_on_card(cuda_device, a, k, b, n):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = n * (n // 2 + 1)
    p = torch.randn(a, k, w, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    C = torch.randn(b, k, w, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    bias = torch.randn(b, device=cuda_device, generator=gen)
    kw = dict(p_scale=1.0 / b, bias=bias, bias_scale=float(n * n))
    before = sk.LAUNCHES
    got = sk.cmul_contract(p, C.transpose(0, 1), **kw)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 1
    want = sk.cmul_contract_plain(p, C.transpose(0, 1), **kw)
    assert rel(got.cpu(), want.cpu()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,m,n", [(8, 3, 10, 128), (8, 10, 3, 128),
                                     (2, 2, 20, 37)])
def test_conv_valid_kernel_matches_plain_on_card(cuda_device, b, d, m, n):
    # held against the plain version in float64, where cuDNN uses no TF32
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    xpad = torch.randn(b, d, n + 4, n + 7, device=cuda_device, generator=gen)
    w = torch.randn(m, d, 5, 5, device=cuda_device, generator=gen)
    before = ck.LAUNCHES
    got = ck.conv_valid(xpad, w)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 1
    want = ck.conv_valid_plain(xpad.double(), w.double())
    assert rel(got.cpu(), want.cpu()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("a,k,b,n", [(8, 10, 3, 128), (10, 8, 10, 32),
                                     (3, 2, 17, 16)])
def test_cmul_contract_conj_and_strided_p_on_card(cuda_device, a, k, b, n):
    """The backward's two forms: ``q`` conjugated, and ``p`` a transposed
    view (``gᵀ`` for the kernel-spectrum gradient), against the plain
    version."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    w = n * (n // 2 + 1)
    g = torch.randn(k, a, w, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    q = torch.randn(k, b, w, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    p = g.transpose(0, 1)                        # [a, k, w], strided
    before = sk.LAUNCHES
    got = sk.cmul_contract(p, q, p_scale=0.1, conj_q=True)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 1
    want = sk.cmul_contract_plain(p.contiguous(), q, p_scale=0.1,
                                  conj_q=True)
    assert rel(got.cpu(), want.cpu()) < TOL


@pytest.mark.cuda
def test_cmul_contract_resolves_lazy_conjugates_on_card(cuda_device):
    """A lazily conjugated view flags unconjugated storage; the wrapper
    materialises it before the launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    p = torch.randn(2, 3, 40, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    q = torch.randn(3, 4, 40, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    for pv, qv in ((p.conj(), q), (p, q.conj())):
        assert pv.is_conj() or qv.is_conj()
        got = sk.cmul_contract(pv, qv)
        want = sk.cmul_contract_plain(pv.resolve_conj(), qv.resolve_conj())
        assert rel(got.cpu(), want.cpu()) < TOL


@pytest.mark.cuda
def test_spectral_conv_fused_grads_on_card(cuda_device):
    """The Function's backward (two K1 launches) against autograd through
    the plain einsum, on the card."""
    from spectralae_torch.ops import dft
    from spectralae_torch.ops import spectral
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    n, nb, d, m = 64, 4, 3, 10
    x = torch.randn(nb, d, n, n, device=cuda_device, generator=gen)
    c0 = torch.randn(m, d, 5, 5, device=cuda_device, generator=gen)
    b0 = torch.randn(m, device=cuda_device, generator=gen)
    dy = torch.randn(nb, m, n, n, device=cuda_device, generator=gen)
    grads = []
    for conv in (sk.spectral_conv_fused, spectral.spectral_conv_einsum):
        X = torch.fft.rfft2(x.clone().requires_grad_())
        leaves = [X, c0.clone().requires_grad_(), b0.clone().requires_grad_()]
        C = dft.kernel_spectrum(leaves[1], n, n)
        y = torch.fft.irfft2(conv(X, C, leaves[2], n, n), s=(n, n))
        before = sk.LAUNCHES
        grads.append(torch.autograd.grad(y, [X] + leaves[1:], dy))
        if conv is sk.spectral_conv_fused:
            assert sk.LAUNCHES == before + 2     # dX and dC
    for got, want in zip(*grads):
        assert rel(got.cpu(), want.cpu()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("data_grad_kernel", [False, True])
def test_conv_valid_grads_on_card(cuda_device, monkeypatch,
                                  data_grad_kernel):
    """dx (through K2 with the flag) and dw against autograd through the
    plain version in float64.  cuDNN runs without TF32; dw sums 16384
    products per weight in float32, hence 1e-5 for it."""
    monkeypatch.setattr(ck, "PALLAS_DATA_GRAD", data_grad_kernel)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    xpad = torch.randn(4, 10, 68, 68, device=cuda_device, generator=gen)
    w = torch.randn(3, 10, 5, 5, device=cuda_device, generator=gen)
    dy = torch.randn(4, 3, 64, 64, device=cuda_device, generator=gen)
    xt, wt = xpad.clone().requires_grad_(), w.clone().requires_grad_()
    before = ck.LAUNCHES
    ck.conv_valid(xt, wt).backward(dy)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 1 + int(data_grad_kernel)
    x64 = xpad.double().requires_grad_()
    w64 = w.double().requires_grad_()
    ck.conv_valid_plain(x64, w64).backward(dy.double())
    assert rel(xt.grad.cpu(), x64.grad.cpu()) < TOL
    assert rel(wt.grad.cpu(), w64.grad.cpu()) < 1e-5
