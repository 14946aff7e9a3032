"""Momentum-space (frequency-domain) ops on the rfft2 half-spectrum layout.

Port of :mod:`spectralae.ops.spectral`.  The transforms are ``torch.fft``
(cuFFT on the card, pocketfft on the CPU); the mask/einsum ops are plain
tensor code, the pointwise complex conv routes onto the hand-written kernel
K1 (:mod:`spectralae_torch.ops.spectral_kernels`) for batched CUDA
spectra, and the pooling's resize onto the remap kernel
(:mod:`spectralae_torch.ops.resize_kernels`) for CUDA spectra.

Spectrum layout: ``[..., Nx, Ny//2+1]`` complex64 — identical to cuFFT R2C
(fft_backproplib.cu:775).  All index quirks of the reference's ``resize``
kernel (Nyquist row/column handling) are reproduced bit-for-bit; see
:func:`spectral_resize`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._kernels import kernel_route, tensor_cache
from ..core import profiling
from . import resize_kernels


def rfft2(x: torch.Tensor) -> torch.Tensor:
    """Batched 2-D R2C transform (reference ``fft``, fft_backproplib.cu:764);
    the span ``transform``."""
    with profiling.span("transform"):
        return torch.fft.rfft2(x)


def irfft2(X: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Normalized C2R — matches reference ``fft_inv`` which scales by
    ``1/(Nx·Ny)`` after the unnormalized cuFFT (fft_backproplib.cu:831);
    the span ``transform``."""
    with profiling.span("transform"):
        return torch.fft.irfft2(X, s=shape)


def irfft2_unnormalized(X: torch.Tensor,
                        shape: tuple[int, int]) -> torch.Tensor:
    """Raw cufftExecC2R semantics (no 1/N) — the reference applies *no*
    normalization when inverse-transforming weight gradients
    (fft_backproplib.cu:1219-1220)."""
    return torch.fft.irfft2(X, s=shape) * (shape[0] * shape[1])


@functools.lru_cache(maxsize=None)
def _resize_maps(nx: int, ny: int, nxs: int, nys: int):
    """Static gather indices + masks for :func:`spectral_resize`.

    Row/column index maps transcribed from the reference ``resize`` CUDA
    kernel (fft_backproplib.cu:87-157), including its quirks: the output
    Nyquist row/column is always copied from the *input* Nyquist row/column.
    """
    nyr, nyrs = ny // 2 + 1, nys // 2 + 1
    rows = np.zeros(nxs, np.int32)
    row_mask = np.ones(nxs, np.float32)
    cols = np.zeros(nyrs, np.int32)
    col_mask = np.ones(nyrs, np.float32)
    if nxs <= nx:  # downsample (spectrum crop)
        for i in range(nxs):
            if i < nxs // 2:
                rows[i] = i
            elif i == nxs // 2:
                rows[i] = nx // 2
            else:
                rows[i] = i + nx - nxs
        for j in range(nyrs):
            cols[j] = j if j < nyrs - 1 else nyr - 1
    else:  # upsample (zero-pad around the spectrum)
        for i in range(nxs):
            if i < nx // 2:
                rows[i] = i
            elif i > nxs - nx // 2:
                rows[i] = i - nxs + nx
            elif i == nxs // 2:
                rows[i] = nx // 2
            else:
                row_mask[i] = 0.0
        for j in range(nyrs):
            if j < nyr - 1:
                cols[j] = j
            elif j == nyrs - 1:
                cols[j] = nyr - 1
            else:
                col_mask[j] = 0.0
    return rows, row_mask, cols, col_mask


@functools.lru_cache(maxsize=None)
def _remap_maps(nx: int, ny: int, nxs: int, nys: int,
                adjoint: bool) -> tuple[np.ndarray, np.ndarray]:
    """The row and column maps of :func:`spectral_resize` as one remap
    (int32, ``-1`` where the output is zero), or, with ``adjoint``, of its
    adjoint: the inverse maps, from ``[nxs, nys//2+1]`` back to
    ``[nx, ny//2+1]``, ``-1`` where no output bin reads the input bin.

    Where :func:`_resize_maps`' mask is 1 its maps are one to one, so the
    inverse exists (``test_resize_maps_invert_where_the_mask_is_one``)."""
    rows, row_mask, cols, col_mask = _resize_maps(nx, ny, nxs, nys)
    maps = (np.where(row_mask > 0, rows, -1).astype(np.int32),
            np.where(col_mask > 0, cols, -1).astype(np.int32))
    if not adjoint:
        return maps
    inverse = []
    for m, n in zip(maps, (nx, ny // 2 + 1)):
        kept = np.flatnonzero(m >= 0)
        inv = np.full(n, -1, np.int32)
        inv[m[kept]] = kept
        inverse.append(inv)
    return tuple(inverse)


@tensor_cache
def _resize_tensors(nx: int, ny: int, nxs: int, nys: int,
                    device: torch.device, adjoint: bool = False):
    """:func:`_remap_maps` as the plain version's gather indices (0 where
    the map is -1) and float32 mask, kept on ``device``.

    Built outside inference mode: a tensor made under
    ``torch.inference_mode()`` (a serving forward may fill the cache) could
    never be saved for a later backward."""
    rows, cols = _remap_maps(nx, ny, nxs, nys, adjoint)
    mask = ((rows >= 0)[:, None] & (cols >= 0)[None, :]).astype(np.float32)
    with torch.inference_mode(False):
        return (torch.as_tensor(np.maximum(rows, 0), dtype=torch.long,
                                device=device),
                torch.as_tensor(np.maximum(cols, 0), dtype=torch.long,
                                device=device),
                torch.as_tensor(mask, device=device))


def resize_plain(X: torch.Tensor, nx: int, ny: int, nxs: int, nys: int,
                 adjoint: bool = False) -> torch.Tensor:
    """The resize (``[..., nx, ny//2+1]`` → ``[..., nxs, nys//2+1]``), or
    with ``adjoint`` its adjoint (back), as plain tensor code: two
    ``index_select`` gathers on :func:`_remap_maps` and a mask multiply.
    The plain version of the kernel
    (:func:`spectralae_torch.ops.resize_kernels.spectral_resize`); autograd
    through it gives the gathers' ``index_add`` gradient."""
    rows, cols, mask = _resize_tensors(nx, ny, nxs, nys, X.device, adjoint)
    out = X.index_select(-2, rows).index_select(-1, cols)
    return out * mask


def spectral_resize(X: torch.Tensor, nx: int, ny: int, nxs: int,
                    nys: int) -> torch.Tensor:
    """Spectral pooling: crop (down) or zero-pad (up) an rfft2 half-spectrum.

    No amplitude rescale — the reference's ``/=l`` is commented out
    (fft_backproplib.cu:154-155), so spatial amplitudes scale by ``scale²``
    across a down/up round trip leg (and cancel over a symmetric net).
    Reference: ``resize`` fft_backproplib.cu:87-157 via ``pool_fft`` 975-1002.

    CUDA spectra (and either device while ``torch.export`` traces or a
    :data:`~spectralae_torch._kernels.HOOK` is set:
    :func:`~spectralae_torch._kernels.kernel_route`) take the hand-written
    remap kernel, forward and adjoint
    (:class:`spectralae_torch.ops.resize_kernels.SpectralResize`, or the
    kernel's wrapper alone where no gradient is taken); everything else
    :func:`resize_plain`.  The two agree bit for bit.
    """
    if kernel_route(X):
        if X.requires_grad and torch.is_grad_enabled():
            return resize_kernels.SpectralResize.apply(X, nx, ny, nxs, nys)
        return resize_kernels.spectral_resize(X, nx, ny, nxs, nys)
    return resize_plain(X, nx, ny, nxs, nys)


def spectral_pool(X: torch.Tensor, nx: int, ny: int,
                  scale: int) -> tuple[torch.Tensor, int, int]:
    """Signed-scale spectral pooling (reference ``pool_fft``).

    ``scale>1``: downsample by crop; ``scale<-1``: upsample by zero-pad.
    Returns the resized spectrum and the new spatial dims.  A resize is the
    span ``pool``, its backward (the adjoint resize) ``pool.grad``.
    """
    if scale == 1 or scale == -1 or scale == 0:
        return X, nx, ny
    if scale > 0:
        nxs, nys = nx // scale, ny // scale
    else:
        nxs, nys = nx * (-scale), ny * (-scale)
    with profiling.span("pool"):
        out = spectral_resize(X, nx, ny, nxs, nys)
    return profiling.grad_span("pool.grad", out, X), nxs, nys


def spectral_conv(X: torch.Tensor, C: torch.Tensor, b: torch.Tensor | None,
                  nx: int, ny: int, *, scale_by_dm: bool = True,
                  compute_dtype=None,
                  m_global: int | None = None) -> torch.Tensor:
    """Pointwise complex-multiply convolution with DC-bin bias.

    ``out[b,m,ω] = Σ_d (X[b,d,ω]/M)·C[m,d,ω]``, with ``b[m]·Nx·Ny`` added to
    the DC bin — equivalent to a spatial ``+b[m]`` after the normalized
    inverse FFT.  Reference: ``conv_k`` fft_backproplib.cu:162-189.

    Batched CUDA spectra go through the hand-written kernel K1
    (:func:`spectralae_torch.ops.spectral_kernels.spectral_conv_fused`);
    everything else through :func:`spectral_conv_einsum`, as the JAX
    package routes its Pallas kernel.  While ``torch.export`` traces, batched
    spectra on either device take K1's operator
    (:func:`~spectralae_torch._kernels.kernel_route`).

    Args:
      X: ``[B, D, Nx, Nyr]`` complex input spectra.
      C: ``[M, D, Nx, Nyr]`` complex kernel spectra.
      b: ``[M]`` real biases.
      compute_dtype: ``torch.bfloat16`` streams bf16 operands (float32
        sums, complex64 result) — through K1's bf16 mode on the card;
        ``None`` is float32.
      m_global: the whole stage's M where ``C`` holds a slice of its
        output channels (the model axis): the scale stays ``1/M``.
        ``None``: ``C.shape[0]``.

    ``X`` and ``C`` may hold a slab of the grid's rows (the bias goes on
    the slab's first bin; ``b=None`` adds none, for a slab without row 0);
    ``nx``, ``ny`` stay the whole grid's.

    The span ``spectral_conv``, its backward ``spectral_conv.grad``, on
    either route.
    """
    with profiling.span("spectral_conv"):
        if X.dim() == 4 and kernel_route(X):
            from .spectral_kernels import spectral_conv_fused
            out = spectral_conv_fused(X, C, b, nx, ny, scale_by_dm,
                                      compute_dtype, m_global=m_global)
        else:
            out = spectral_conv_einsum(X, C, b, nx, ny,
                                       scale_by_dm=scale_by_dm,
                                       compute_dtype=compute_dtype,
                                       m_global=m_global)
    return profiling.grad_span("spectral_conv.grad", out, X, C, b)


def spectral_conv_einsum(X: torch.Tensor, C: torch.Tensor,
                         b: torch.Tensor | None, nx: int, ny: int, *,
                         scale_by_dm: bool = True, compute_dtype=None,
                         m_global: int | None = None) -> torch.Tensor:
    """The plain pointwise conv (no kernel dispatch); ``m_global`` and
    ``b=None`` as in :func:`spectral_conv`.

    With ``compute_dtype`` it runs the JAX package's reduced branch: the
    four real products of the bf16-rounded operands (``X/M`` rounded after
    the scale), summed in float32 — rounded, then upcast, since PyTorch's
    einsum has no ``preferred_element_type``."""
    from .spectral_kernels import check_compute_dtype
    check_compute_dtype(compute_dtype)
    m = m_global or C.shape[0]
    scale = (1.0 / m) if scale_by_dm else 1.0
    if compute_dtype is not None:
        def rnd(t):
            return t.to(compute_dtype).to(torch.float32)
        xr, xi = rnd(X.real * scale), rnd(X.imag * scale)
        cr, ci = rnd(C.real), rnd(C.imag)
        eq = "mdxy,bdxy->bmxy"
        out = torch.complex(
            torch.einsum(eq, cr, xr) - torch.einsum(eq, ci, xi),
            torch.einsum(eq, cr, xi) + torch.einsum(eq, ci, xr))
    else:
        out = torch.einsum("mdxy,bdxy->bmxy", C, X * scale)
    if b is not None:
        # the einsum result is fresh, so the DC add may update it in place
        out[..., 0, 0] += b.to(out.dtype) * (nx * ny)
    return out


def kernel_pad(c: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """Circularly zero-pad a compact ``[..., Nk, Nl]`` kernel to
    ``[..., Nx, Ny]`` with the kernel center at the origin (split across the
    4 corners).

    Equivalent to the reference's quadrant copy (``kernel_pad``
    fft_backproplib.cu:1018-1064, ``pad_k`` 570-600) — here a single
    place + ``torch.roll``.
    """
    nk, nl = c.shape[-2], c.shape[-1]
    full = c.new_zeros(c.shape[:-2] + (nx, ny))
    full[..., :nk, :nl] = c
    return torch.roll(full, (-(nk // 2), -(nl // 2)), dims=(-2, -1))


def kernel_shrink(full: torch.Tensor, nk: int, nl: int) -> torch.Tensor:
    """Inverse of :func:`kernel_pad`: extract the compact ``Nk×Nl`` support
    from the 4 corners of a full-size circular array.

    Reference: ``shrink_k`` fft_backproplib.cu:535-565,
    ``kernel_invpad`` 1069-1112.
    """
    rolled = torch.roll(full, (nk // 2, nl // 2), dims=(-2, -1))
    return rolled[..., :nk, :nl]


def kernel_rfft(c: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """Compact kernel → full half-spectrum: the lazily-cached ``net_cfreq``
    entry of the reference (``StoreLoad_cfreq`` fft_backproplib.cu:1146-1161).

    Recomputed per call as a rank-P restricted-DFT product
    (:func:`spectralae_torch.ops.dft.kernel_spectrum`) for supports of up to
    256 taps, instead of padding to the full grid and transforming; larger
    supports take the padded FFT, as in the JAX package.  The span
    ``kernel_spectra``.
    """
    with profiling.span("kernel_spectra"):
        if c.shape[-2] * c.shape[-1] <= 256:
            from . import dft
            return dft.kernel_spectrum(c, nx, ny)
        return rfft2(kernel_pad(c, nx, ny))


def kernel_irfft(C: torch.Tensor, nk: int, nl: int, nx: int,
                 ny: int) -> torch.Tensor:
    """Half-spectrum → compact kernel (reference ``export_cfreq``
    fft_backproplib.cu:1166-1172: normalized ``kfft_inv`` + ``kernel_invpad``)."""
    return kernel_shrink(irfft2(C, (nx, ny)), nk, nl)


@functools.lru_cache(maxsize=None)
def _hermitian_weights(nx: int, ny: int) -> np.ndarray:
    """Per-column double-count weights for half-spectrum reductions.

    Interior columns represent two conjugate bins of the full spectrum;
    the reference halves their norm (``n/=2``, fft_backproplib.cu:495) which
    doubles their weight.  The last column is self-conjugate (weight 1) only
    for even ``ny`` — for odd ``ny`` it pairs like any interior column.
    """
    nyr = ny // 2 + 1
    w = np.full((nyr,), 2.0, np.float32)
    w[0] = 1.0
    if ny % 2 == 0:
        w[-1] = 1.0
    return w


def parseval_mse(X: torch.Tensor, O: torch.Tensor, d_norm: int, m_norm: int,
                 nx: int, ny: int) -> torch.Tensor:
    """Spectral MSE with Hermitian double-count correction.

    ``mse = Σ_bins w_j·|X-O|² / (d·Nx·Ny) / (2·m·Nx·Ny)`` — exactly the
    reference's ``calc_mse`` (fft_backproplib.cu:480-498) +
    ``mse_fft`` norm (1178-1192).  By Parseval this equals
    ``Σ_pixels (x-o)² / (2·m·d·Nx·Ny)``.
    """
    w = torch.as_tensor(_hermitian_weights(nx, ny), device=X.device)
    diff = X - O
    per_bin = (diff.real ** 2 + diff.imag ** 2) * w
    return torch.sum(per_bin) / (d_norm * nx * ny) / (2 * m_norm * nx * ny)
