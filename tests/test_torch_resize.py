"""The spectral pooling's remap kernel (``ops/resize_kernels.py``,
``csrc/spectral_resize.cu``) against its plain version.

The kernel's results are the gathers' bit for bit (``torch.equal``): the
gathers copy, the mask multiplies by 1 or 0, and the ``index_add`` adds
each value to a zero.  On the CPU the kernel's route runs its plain
version.  Tests marked ``cuda`` launch the kernel and need an NVIDIA GPU;
they skip without one.  This file imports no JAX::

    python -m pytest tests/test_torch_resize.py -m cuda --noconftest
"""

import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.ops import resize_kernels as rk
from spectralae_torch.ops import spectral

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _spectra(gen, *shape, device="cpu", requires_grad=False):
    return torch.randn(shape, dtype=torch.complex64, generator=gen,
                       device=device, requires_grad=requires_grad)


def _pooled(nx, ny, scale):
    return ((nx // scale, ny // scale) if scale > 0
            else (nx * -scale, ny * -scale))


def _gather_grad(X, nx, ny, nxs, nys, g):
    """The gradient the port took before the kernel: autograd through the
    plain gathers (a mask multiply, two ``index_add``)."""
    X = X.detach().requires_grad_(True)
    out = spectral.resize_plain(X, nx, ny, nxs, nys)
    return torch.autograd.grad(out, X, g)[0]


@pytest.mark.parametrize("nx,ny,nxs,nys,adjoint", [
    (16, 16, 8, 8, False), (16, 16, 8, 8, True),
    (9, 9, 18, 18, False), (9, 9, 18, 18, True)])
def test_resize_dims_and_column_form(nx, ny, nxs, nys, adjoint):
    """The planes each direction reads and writes, and the column map the
    kernel computes (it reads no column map): the identity up to
    ``min(w_in, w_out) - 1``, zeros, the input's last column in the
    output's last."""
    h_in, w_in, h_out, w_out = rk.resize_dims(nx, ny, nxs, nys, adjoint)
    big, small = (nx, ny // 2 + 1), (nxs, nys // 2 + 1)
    assert ((h_in, w_in), (h_out, w_out)) == ((small, big) if adjoint
                                              else (big, small))
    k = min(w_in, w_out) - 1
    _, cols = spectral._remap_maps(nx, ny, nxs, nys, adjoint)
    assert cols[:k].tolist() == list(range(k))
    assert (cols[k:-1] == -1).all() and cols[-1] == w_in - 1


@pytest.mark.parametrize("shape,dims,adjoint", [
    ((2, 3, 16, 8), (16, 16, 8, 8), False),     # not the input's planes
    ((2, 3, 16, 9), (16, 16, 8, 8), True),      # the forward's input
    ((9,), (16, 16, 8, 8), False)])             # no plane
def test_spectral_resize_rejects_what_the_kernel_does_not_take(shape, dims,
                                                              adjoint):
    with pytest.raises(ValueError):
        rk.spectral_resize(torch.zeros(shape, dtype=torch.complex64), *dims,
                           adjoint=adjoint)


def test_the_route_counts_one_kernel_call_each_way():
    """Through the route (a hook sees every kernel wrapper's call), a
    resize is one ``spectral_resize`` call forward and one adjoint call
    back; an input that needs no gradient makes none back."""
    calls = []

    def hook(fn, args, kwargs):
        calls.append((fn.__name__, kwargs.get("adjoint", False)))
        return fn(*args, **kwargs)
    gen = torch.Generator().manual_seed(0)
    w = _spectra(gen, 2, 3, 8, 5, requires_grad=True)
    _kernels.HOOK = hook
    try:
        for needs in (True, False):
            X = _spectra(gen, 2, 3, 16, 9, requires_grad=needs)
            (spectral.spectral_resize(X, 16, 16, 8, 8) * w).abs().sum() \
                .backward()
    finally:
        _kernels.HOOK = None
    assert calls == [("spectral_resize", False), ("spectral_resize", True),
                     ("spectral_resize", False)]


# the six resizes of the benchmark's fft steps at 1024², at batch 2 (the
# channels each pools), then odd sizes, scale 3 and a non-square grid
CARD_CASES = [
    (3, 1024, 1024, 2), (10, 512, 512, 2), (10, 256, 256, 2),
    (10, 128, 128, -2), (10, 256, 256, -2), (3, 512, 512, -2),
    (3, 18, 18, 2), (3, 9, 9, -2), (2, 24, 24, 3), (2, 6, 10, -3),
    (2, 15, 9, 2), (2, 35, 66, -2)]


@pytest.mark.cuda
@pytest.mark.parametrize("ch,nx,ny,scale", CARD_CASES)
def test_spectral_resize_kernel_matches_plain_on_card(cuda_device, ch, nx,
                                                      ny, scale):
    """Forward and adjoint, one launch each, bit for bit the plain
    version's; the autograd gradient bit for bit the gathers'."""
    nxs, nys = _pooled(nx, ny, scale)
    gen = torch.Generator(device=cuda_device).manual_seed(nx + ny + scale)
    X = _spectra(gen, 2, ch, nx, ny // 2 + 1, device=cuda_device)
    g = _spectra(gen, 2, ch, nxs, nys // 2 + 1, device=cuda_device)
    before = _kernels.LAUNCHES["spectral_resize"]
    fwd = rk.spectral_resize(X, nx, ny, nxs, nys)
    adj = rk.spectral_resize(g, nx, ny, nxs, nys, adjoint=True)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["spectral_resize"] == before + 2
    assert torch.equal(fwd, spectral.resize_plain(X, nx, ny, nxs, nys))
    assert torch.equal(adj, spectral.resize_plain(g, nx, ny, nxs, nys, True))
    Xg = X.clone().requires_grad_(True)
    out = spectral.spectral_resize(Xg, nx, ny, nxs, nys)
    grad, = torch.autograd.grad(out, Xg, g)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["spectral_resize"] == before + 4
    assert torch.equal(out, fwd)
    assert torch.equal(grad, _gather_grad(X, nx, ny, nxs, nys, g))


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["channel_slice", "transposed", "conj"])
def test_spectral_resize_kernel_takes_any_view_on_card(cuda_device, view):
    """A non-contiguous input (a channel slice, the model axis's; a
    transposed batch) and a lazily conjugated one equal the plain
    version's result on the same view."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    base = _spectra(gen, 4, 6, 64, 33, device=cuda_device)
    X = {"channel_slice": base[:, 2:5], "transposed": base.transpose(0, 1),
         "conj": base.conj()}[view]
    assert not X.is_contiguous() or X.is_conj()
    for nxs in (32, 128):
        got = rk.spectral_resize(X, 64, 64, nxs, nxs)
        torch.cuda.synchronize()
        want = spectral.resize_plain(X.resolve_conj(), 64, 64, nxs, nxs)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_an_input_without_gradient_launches_no_adjoint_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    w = _spectra(gen, 2, 3, 64, 33, device=cuda_device, requires_grad=True)
    for needs, launches in ((False, 1), (True, 2)):
        X = _spectra(gen, 2, 3, 128, 65, device=cuda_device,
                     requires_grad=needs)
        before = _kernels.LAUNCHES["spectral_resize"]
        (spectral.spectral_resize(X, 128, 128, 64, 64) * w).abs().sum() \
            .backward()
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["spectral_resize"] - before == launches
