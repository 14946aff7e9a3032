"""Configuration and shape math for the spectral autoencoder.

Reference parity notes
----------------------
The reference derives odd kernel sizes from half-extents ``Lk, Ll`` as
``Nk = 2*(Lk+1)+1`` (reference: source/autoencoder.cpp:35-36,43-44) and reads a
5-line ``name value`` config file (source/netlib.cpp:274-289,
New_Layer_Param.txt:1-5).  Default hyperparameters mirror
source/autoencoder.cpp:28-44,86-96.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Literal

TapMode = Literal["centered", "ref_cpu", "ref_gpu"]


def kernel_size(half_extent: int) -> int:
    """Odd kernel size from the reference's half-extent parameterization.

    ``Nk = 2*(Lk+1)+1`` (reference: source/autoencoder.cpp:35).
    """
    return 2 * (half_extent + 1) + 1


def half_extent(size: int) -> int:
    """Inverse of :func:`kernel_size` — used in checkpoint filenames.

    ``Lk = (Nk-1)/2 - 1`` (reference: source/netlib.cpp:233).
    """
    return (size - 1) // 2 - 1


def tap_anchor(size: int, mode: TapMode) -> int:
    """First tap offset ``ik0`` such that taps read ``in[i - (ik0 + k)]``.

    The reference has *three* inconsistent tap windows:

    - CPU ``Conv``: ``a = (Nk-1)/2 - 1``, taps start at ``ik = -2a-1``
      (source/netlib.cpp:325-341).
    - GPU ``conv_parallel``: ``a = ((Nk-1)/2 - 1)/2`` with the same start
      formula (source/backproplib.cu:123-124,89) — a *different* window.
    - FFT path: centered circular convolution via the corner-quadrant kernel
      pad (source/fft_backproplib.cu:1018-1064).

    ``centered`` (our default) makes the coordinate path agree with the
    spectral path: taps run over ``in[i-δ]`` for ``δ ∈ [-Nk//2, Nk//2]``.
    """
    if mode == "centered":
        return -(size // 2)
    if mode == "ref_cpu":
        a = (size - 1) // 2 - 1
        return -2 * a - 1
    if mode == "ref_gpu":
        a = ((size - 1) // 2 - 1) // 2
        return -2 * a - 1
    raise ValueError(f"unknown tap mode: {mode!r}")


@dataclasses.dataclass(frozen=True)
class LayerParams:
    """Per-layer structural parameters (the ``New_Layer_Param.txt`` contents).

    Reference: New_Layer_Param.txt:1-5 parsed by source/netlib.cpp:274-289.
    """

    depth: int = 10        # M  — feature maps of the new conv stage
    lk: int = 1            # Lk — kernel half-extent (rows)
    ll: int = 1            # Ll — kernel half-extent (cols)
    scale: int = 2         # pooling factor of the new stage
    rmax: float = 3.0      # uniform init range [-rmax, rmax]

    @property
    def nk(self) -> int:
        return kernel_size(self.lk)

    @property
    def nl(self) -> int:
        return kernel_size(self.ll)


def load_layer_params(path: str | Path) -> LayerParams:
    """Parse the reference's 5-line ``name value`` config file.

    Positional parse, names ignored — matching source/netlib.cpp:280-288.
    """
    values: list[float] = []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 2:
            values.append(float(parts[1]))
    if len(values) < 5:
        raise ValueError(f"expected 5 'name value' lines in {path}")
    return LayerParams(
        depth=int(values[0]),
        lk=int(values[1]),
        ll=int(values[2]),
        scale=int(values[3]),
        rmax=values[4],
    )


def save_layer_params(params: LayerParams, path: str | Path) -> None:
    Path(path).write_text(
        f"Layer_depth {params.depth}\n"
        f"Kernel_L_x {params.lk}\n"
        f"Kernel_L_y {params.ll}\n"
        f"Pooling_scale {params.scale}\n"
        f"Max_Rand_Init {params.rmax}\n"
    )


@dataclasses.dataclass(frozen=True)
class Config:
    """Global run configuration (reference: source/autoencoder.cpp:27-96)."""

    nx: int = 256          # frame rows
    ny: int = 256          # frame cols
    d: int = 3             # input depth (RGB)
    layer: LayerParams = dataclasses.field(default_factory=LayerParams)

    # training controls (keyboard-mutable in the reference)
    lr: float = 0.2        # 'del' max learning rate (autoencoder.cpp:87)
    alpha: float = 0.9     # inertia / momentum weight (autoencoder.cpp:89)
    q: int = 1             # training-patch shrink factor (autoencoder.cpp:86)
    active_lr: bool = True  # '9' key; a no-op in the reference coord path
    sym: bool = False      # symmetric encoder/decoder weights ('p')
    maxdiff: bool = False  # multiobjective kernel-diversity loss ('m')
    fft_iters: int = 100   # inner iterations per FFT train burst
                           # (source/fft_backproplib.cu:1446)
    maxdiff_w0: float = 1.0   # reconstruction weight (fft_backproplib.cu:1252)
    maxdiff_w1: float = 10.0  # diversity weight       (fft_backproplib.cu:1252)

    # numerics
    tap_mode: TapMode = "centered"
    scale_by_dm: bool = True  # divide conv input by output depth
                              # (backproplib.cu:134, fft_backproplib.cu:176-177)
    dtype: str = "float32"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
