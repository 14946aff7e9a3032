"""Spectrum visualization: magnitude images of rfft2 half-spectra.

Functional equivalents of the reference's (dead but shipped) display
kernels ``magnitude`` / ``shift_magnitude`` (source/fft_backproplib.cu:27-63):
reconstruct the full Nx×Ny magnitude plane from the Hermitian half-spectrum
and optionally roll DC to the center for display.

A copy of :mod:`spectralae.viz.spectrum` (framework-free: it works on numpy).
"""

from __future__ import annotations

import numpy as np


def magnitude(spec: np.ndarray, nx: int, ny: int) -> np.ndarray:
    """Half-spectrum ``[..., Nx, Nyr]`` → full ``[..., Nx, Ny]`` magnitude.

    Mirrors the Hermitian completion of fft_backproplib.cu:48-63 (the right
    half is read from the conjugate bin) with the same ``sqrt(|z|/N)``
    compression.
    """
    spec = np.asarray(spec)
    nyr = ny // 2 + 1
    ntot = spec.shape[-3] * nx * ny if spec.ndim >= 3 else nx * ny
    mag_half = np.sqrt(np.abs(spec) / ntot)
    out = np.zeros(spec.shape[:-2] + (nx, ny), np.float32)
    out[..., :, :nyr] = mag_half
    # the true conjugate bin of (i, j>=nyr) is ((-i) mod Nx, Ny-j); the
    # reference's map (fft_backproplib.cu:57) is off by one in both axes —
    # display-only dead code there, implemented correctly here
    i = (-np.arange(nx)) % nx
    j = np.arange(nyr, ny)
    out[..., :, nyr:] = mag_half[..., i[:, None], ny - j]
    return out


def shift_magnitude(mag: np.ndarray) -> np.ndarray:
    """Roll zero frequency to the image center
    (fft_backproplib.cu:27-43 ≙ fftshift)."""
    nx, ny = mag.shape[-2], mag.shape[-1]
    return np.roll(mag, (nx // 2, ny // 2), axis=(-2, -1))


def spectrum_image(spec: np.ndarray, nx: int, ny: int, *,
                   shift: bool = True) -> np.ndarray:
    """uint8 display image of a single channel's spectrum."""
    mag = magnitude(spec, nx, ny)
    if shift:
        mag = shift_magnitude(mag)
    mx = float(mag.max()) or 1.0
    return np.clip(255.0 * mag / mx, 0, 255).astype(np.uint8)
