"""Hand-written CUDA kernel for the spectral pooling's resize and its
adjoint (``csrc/spectral_resize.cu``).

The JAX package leaves the resize to XLA's gathers (``spectral_resize``,
the reference's ``resize`` kernel, fft_backproplib.cu:87-157); it replaces
no Pallas kernel.  Its plain version,
:func:`spectralae_torch.ops.spectral.resize_plain`, is two ``index_select``
gathers and a mask multiply, whose autograd gradient is a mask multiply
and two ``index_add`` into zero-filled buffers.  Where the mask is 1 the
resize's maps are one to one, so the resize and its adjoint are one remap
(:func:`spectralae_torch.ops.spectral._remap_maps`): every output bin is
written once, from one input bin or as a zero.  The kernel does that in one
pass; the source's header note says what bounds it and how it is shaped.

:class:`SpectralResize` is the differentiable resize: its backward is the
same kernel on the inverse maps, launched only where the input needs a
gradient.  The kernel is the PyTorch operator
``spectralae_torch::spectral_resize`` (:data:`spectral_resize_op`,
registered by :func:`spectralae_torch._kernels.operator`), so a traced
graph holds it as one node a resize.  Its CPU kernel is the plain version,
its CUDA kernel the launch.
"""

from __future__ import annotations

import torch

from .. import _kernels


def resize_dims(nx: int, ny: int, nxs: int, nys: int,
                adjoint: bool) -> tuple[int, int, int, int]:
    """``(h_in, w_in, h_out, w_out)``: the planes the remap reads and
    writes — ``[nx, ny//2+1]`` to ``[nxs, nys//2+1]``, or back for the
    adjoint."""
    if min(nx, ny, nxs, nys) < 1:
        raise ValueError(f"spectral_resize: sizes {nx}x{ny} -> {nxs}x{nys}")
    big, small = (nx, ny // 2 + 1), (nxs, nys // 2 + 1)
    return (*small, *big) if adjoint else (*big, *small)


@_kernels.tensor_cache
def _row_map(nx: int, ny: int, nxs: int, nys: int, adjoint: bool,
             device: torch.device) -> torch.Tensor:
    """The remap's row map, int32 with -1 for a zero row, kept on
    ``device`` (built outside inference mode, as every cached constant)."""
    from . import spectral
    rows, _ = spectral._remap_maps(nx, ny, nxs, nys, adjoint)
    with torch.inference_mode(False):
        return torch.as_tensor(rows, device=device)


@_kernels.opaque
def spectral_resize(x: torch.Tensor, nx: int, ny: int, nxs: int, nys: int,
                    adjoint: bool = False) -> torch.Tensor:
    """The resize ``[..., nx, ny//2+1]`` → ``[..., nxs, nys//2+1]`` (a crop
    where ``nxs <= nx``, else a zero-pad), or with ``adjoint`` its adjoint
    ``[..., nxs, nys//2+1]`` → ``[..., nx, ny//2+1]``: one remap.  Checks
    the input's planes and calls the operator
    ``spectralae_torch::spectral_resize``: CPU tensors take
    :func:`~spectralae_torch.ops.spectral.resize_plain`, CUDA tensors
    (complex64) launch the kernel.  The result carries no gradient:
    :class:`SpectralResize` does."""
    h_in, w_in, _, _ = resize_dims(nx, ny, nxs, nys, adjoint)
    if x.shape[-2:] != (h_in, w_in):
        raise ValueError(f"spectral_resize takes [..., {h_in}, {w_in}] "
                         f"spectra here, got {tuple(x.shape)}")
    return _spectral_resize(x, int(nx), int(ny), int(nxs), int(nys),
                            bool(adjoint))


def _spectral_resize_cpu(x, nx, ny, nxs, nys, adjoint):
    """The operator's CPU kernel: the plain version."""
    from . import spectral
    return spectral.resize_plain(x, nx, ny, nxs, nys, adjoint)


def _spectral_resize_fake(x, nx, ny, nxs, nys, adjoint):
    _, _, h_out, w_out = resize_dims(nx, ny, nxs, nys, adjoint)
    return x.new_empty(x.shape[:-2] + (h_out, w_out))


def _spectral_resize_cuda(x, nx, ny, nxs, nys, adjoint):
    """One launch of the kernel over the flattened leading dims, into an
    output from ``torch.empty`` (the kernel writes every bin).  The column
    map is the identity up to ``min(w_in, w_out) - 1``
    (``test_resize_dims_and_column_form``); the kernel computes it."""
    if x.dtype != torch.complex64:
        raise TypeError(f"the resize kernel takes complex64, got {x.dtype}")
    h_in, w_in, h_out, w_out = resize_dims(nx, ny, nxs, nys, adjoint)
    # a lazily conjugated or negated view flags its storage but does not
    # change it, and the kernel reads the storage: materialise it
    if x.is_conj() or x.is_neg() or not x.is_contiguous():
        x = x.resolve_conj().resolve_neg().contiguous()
    rows = _row_map(nx, ny, nxs, nys, adjoint, x.device)
    out = x.new_empty(x.shape[:-2] + (h_out, w_out))
    planes = x.numel() // (h_in * w_in)
    if planes == 0:
        return out
    _kernels.launch("spectral_resize_launch", "spectral_resize", x.device,
                    x.data_ptr(), out.data_ptr(), rows.data_ptr(), planes,
                    h_in, w_in, h_out, w_out, min(w_in, w_out) - 1)
    return out


#: the resize's eager call (:func:`spectralae_torch._kernels.operator`):
#: its CPU kernel is the plain version, its CUDA kernel the launch.  Call
#: it through :func:`spectral_resize`, which checks the input.
_spectral_resize = _kernels.operator(
    "spectral_resize", "(Tensor x, int nx, int ny, int nxs, int nys, "
    "bool adjoint) -> Tensor", _spectral_resize_cpu, _spectral_resize_cuda,
    _spectral_resize_fake)
#: the resize as a PyTorch operator, the node a traced graph records
spectral_resize_op = _spectral_resize.op


class SpectralResize(torch.autograd.Function):
    """The resize through :func:`spectral_resize`, differentiable: the
    backward is the adjoint remap of the gradient, one more call of the
    kernel, made only where the input needs a gradient (the first pooling
    of a net reads the frames' spectra, which need none, so it launches
    nothing back)."""

    @staticmethod
    def forward(ctx, X, nx, ny, nxs, nys):
        ctx.dims = (nx, ny, nxs, nys)
        return spectral_resize(X, nx, ny, nxs, nys)

    @staticmethod
    def backward(ctx, g):
        dX = None
        if ctx.needs_input_grad[0]:
            dX = spectral_resize(g, *ctx.dims, adjoint=True)
        return dX, None, None, None, None

