"""Hand-written CUDA kernels for the two probe scripts (P1, P2).

Counterparts of the Pallas kernels in ``scripts/probe_mosaic_features.py``
(P1: ``lane_strided``, ``sublane_strided``, ``middle_store``) and
``scripts/probe_fused_dft.py`` (P2: ``ydft_energy``), all in
``csrc/probes.cu``, whose header note says what bounds each and how it is
shaped.  The scripts ``scripts/torch_probe_mosaic_features.py`` and
``scripts/torch_probe_fused_dft.py`` drive them.

Every wrapper runs its kernel's plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors — never the plain version there.
One ``ydft_energy`` launch is two grids (the sweep, then the ordered sum
of its partials).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels
from .fft_kernels import SWEEP_TILE, _TIERS, split_dot, tile_pieces
from .spectral import _hermitian_weights

#: ``precision`` values :func:`ydft_energy` takes (the JAX tiers): which
#: bf16 pieces of ``x`` and the bases feed the tensor cores on the card
#: (``csrc/wgmma.cuh``); None is ``"default"``
PRECISIONS = (None, "default", "high", "highest")

#: stores of :func:`middle_store` (``out[k] = x·(k+1)`` for ``k < 4``)
MIDDLE_K = 4


def _check(x: torch.Tensor, name: str, ndim: int) -> None:
    if x.dtype != torch.float32 or x.dim() != ndim:
        raise TypeError(f"{name} takes a {ndim}-D float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"{name} needs a non-empty tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor on the card")


# ------------------------------------------------------ P1: the probes

def lane_strided_plain(x: torch.Tensor) -> torch.Tensor:
    """``2·x[:, 1::4]``."""
    return x[:, 1::4] * 2.0


def sublane_strided_plain(x: torch.Tensor) -> torch.Tensor:
    """``2·x[1::4, :]``."""
    return x[1::4, :] * 2.0


def middle_store_plain(x: torch.Tensor) -> torch.Tensor:
    """``out[k] = x·(k+1)`` for ``k < 4``: ``[4, *x.shape]``."""
    k = torch.arange(1, MIDDLE_K + 1, dtype=x.dtype, device=x.device)
    return x[None] * k.reshape(-1, *([1] * x.dim()))


def lane_strided(x: torch.Tensor) -> torch.Tensor:
    """The lane-strided read of a ``[R, C]`` float32 tile: ``2·x[:, 1::4]``
    (``[8, 512] → [8, 128]`` in the probe)."""
    _check(x, "lane_strided", 2)
    if x.device.type == "cpu":
        return lane_strided_plain(x)
    rows, cols = x.shape
    out = torch.empty((rows, len(range(1, cols, 4))), dtype=x.dtype,
                      device=x.device)
    if out.shape[1]:
        _kernels.launch("probe_lane_strided_launch", "lane_strided",
                        x.device, x.data_ptr(), out.data_ptr(), rows, cols,
                        out.shape[1])
    return out


def sublane_strided(x: torch.Tensor) -> torch.Tensor:
    """The sublane-strided read of a ``[R, C]`` float32 tile:
    ``2·x[1::4, :]`` (``[512, 128] → [128, 128]`` in the probe)."""
    _check(x, "sublane_strided", 2)
    if x.device.type == "cpu":
        return sublane_strided_plain(x)
    rows, cols = x.shape
    out = torch.empty((len(range(1, rows, 4)), cols), dtype=x.dtype,
                      device=x.device)
    if out.shape[0]:
        _kernels.launch("probe_sublane_strided_launch", "sublane_strided",
                        x.device, x.data_ptr(), out.data_ptr(), out.shape[0],
                        cols)
    return out


def middle_store(x: torch.Tensor) -> torch.Tensor:
    """Stores into the middle axis of a 3-D block: ``out[k] = x·(k+1)`` for
    ``k < 4`` (``[128, 128] → [4, 128, 128]`` in the probe)."""
    _check(x, "middle_store", 2)
    if x.device.type == "cpu":
        return middle_store_plain(x)
    out = torch.empty((MIDDLE_K, *x.shape), dtype=x.dtype, device=x.device)
    _kernels.launch("probe_middle_store_launch", "middle_store", x.device,
                    x.data_ptr(), out.data_ptr(), x.numel(), MIDDLE_K)
    return out


# ------------------------------------------------------- P2: ydft_energy

@functools.lru_cache(maxsize=None)
def _bases(nx: int, ny: int, device: torch.device):
    """The ``[ny, nyr]`` cos and sin bases of the y-DFT, float32, built in
    float64 on the host as the JAX probe builds them, and the ``[nyr]``
    Hermitian weights."""
    nyr = ny // 2 + 1
    ang = 2 * np.pi * (np.arange(ny)[:, None] * np.arange(nyr)[None, :]) / ny
    return (torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device),
            torch.as_tensor(_hermitian_weights(nx, ny), device=device))


def _chunks(nyr: int, y_chunk: int) -> list[tuple[int, int]]:
    """The JAX probe's ω_y chunk edges."""
    if y_chunk < 1:
        raise ValueError(f"y_chunk must be positive, got {y_chunk}")
    n = max(1, -(-nyr // y_chunk))
    edges = [round(c * nyr / n) for c in range(n + 1)]
    return list(zip(edges, edges[1:]))


@functools.lru_cache(maxsize=None)
def _ydft_tiles_on(ny: int, precision: str,
                   device: torch.device) -> torch.Tensor:
    """The bases as the sweep kernel's B tiles: for bin tile b (64 bins)
    and y chunk c (64 y), the 128 × 64 matrix whose rows are the cos, then
    the sin basis of the tile's bins over the chunk's y, zero past ny and
    nyr; split into ``precision``'s bf16 pieces in the kernels'
    core-matrix order: ``[nb, nc, pieces, 8192]`` bf16, built once on the
    host."""
    nyr = ny // 2 + 1
    tb, ty = SWEEP_TILE
    nb, nc = -(-nyr // tb), -(-ny // ty)
    cosb, sinb = _bases(1, ny, torch.device("cpu"))[:2]

    def tiled(a):
        z = torch.zeros(nc * ty, nb * tb)
        z[:ny, :nyr] = a
        return z.reshape(nc, ty, nb, tb).permute(2, 0, 3, 1)
    b = torch.cat([tiled(cosb), tiled(sinb)], -2)       # [b, c, 128, 64]
    return tile_pieces(b, precision).to(device)


def ydft_energy_plain(x: torch.Tensor, *, y_chunk: int = 512,
                      precision=None) -> torch.Tensor:
    """Plain version of :func:`ydft_energy`: the same matmul DFT, one
    ``y_chunk`` of bins at a time, as the JAX probe chunks it.
    ``precision``: None for float32 products (the CPU route), or the tier
    whose bf16 pieces of ``x`` and the bases the kernel multiplies on the
    card (:func:`~spectralae_torch.ops.fft_kernels.split_dot`)."""
    d, nx, ny = x.shape
    cosb, sinb, w = _bases(nx, ny, x.device)
    x2 = x.reshape(d * nx, ny)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a, b in _chunks(ny // 2 + 1, y_chunk):
        yr = split_dot(x2, cosb[:, a:b], precision)
        yi = -split_dot(x2, sinb[:, a:b], precision)
        total = total + torch.sum(w[a:b] * (yr * yr + yi * yi))
    return total


def ydft_energy(x: torch.Tensor, *, y_chunk: int = 512,
                precision=None) -> torch.Tensor:
    """``Σ_d Σ_rows Σ_ωy w(ωy)·|DFT_y(x)|²`` of ``x [D, nx, ny]`` float32,
    the y-DFT a product with the ``[ny, nyr]`` cos/sin bases and ``w``
    :func:`~spectralae_torch.ops.spectral._hermitian_weights`; a 0-d
    float32 tensor.

    ``y_chunk`` is the JAX probe's ω_y chunking (a TPU memory bound): the
    chunked result equals the unchunked one, and the kernel tiles the bins
    its own way whatever it is.  ``precision`` is the JAX dot tier (None
    is ``"default"``): on the card the kernel multiplies that tier's bf16
    pieces of ``x`` and the bases on the tensor cores; CPU tensors take
    :func:`ydft_energy_plain` in float32 for every tier, as JAX's
    ``jnp.dot`` runs on the CPU.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    _check(x, "ydft_energy", 3)
    _chunks(x.shape[2] // 2 + 1, y_chunk)      # validates y_chunk
    if x.device.type == "cpu":
        return ydft_energy_plain(x, y_chunk=y_chunk)
    tier = "default" if precision is None else precision
    d, nx, ny = x.shape
    rows, nyr = d * nx, ny // 2 + 1
    w = _bases(nx, ny, x.device)[2]
    tiles = _ydft_tiles_on(ny, tier, x.device)
    scratch = torch.empty(_kernels.lib().ydft_energy_blocks(rows, nyr),
                          dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _kernels.launch("ydft_energy_launch", "ydft_energy", x.device,
                    x.data_ptr(), tiles.data_ptr(), w.data_ptr(),
                    scratch.data_ptr(), out.data_ptr(), rows, ny, nyr,
                    _TIERS[tier], *SWEEP_TILE)
    return out


def ref_energy(x: torch.Tensor) -> torch.Tensor:
    """The same energy through ``torch.fft.rfft`` (the JAX probe's
    ``ref_energy``): the library call P2 is timed against."""
    y = torch.fft.rfft(x, dim=-1)
    w = torch.as_tensor(_hermitian_weights(x.shape[-2], x.shape[-1]),
                        device=x.device)
    return torch.sum(w * (y.real ** 2 + y.imag ** 2))
