"""Parameter and shape types: the network is data, not objects.

Port of :mod:`spectralae.core.types`.  The reference keeps the network as
four parallel C++ vectors — activation buffers, kernels, biases, pooling
scales (source/autoencoder.cpp:74-120).  Here the *learnable* state is a
small dataclass of tensors (``AEParams``) and the *structural* state
(shapes, scales) a hashable spec (``NetSpec``).

Initialisation draws from a ``torch.Generator``, so the same seed gives the
same weights on every device but not the JAX package's weights (its
``jax.random`` stream differs).  To carry parameters across frameworks use
:func:`params_from_numpy` / :func:`params_to_numpy`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from .config import Config, LayerParams


@dataclasses.dataclass
class ConvStage:
    """One convolution stage: kernels ``c[M, D, Nk, Nl]`` and biases ``b[M]``.

    Encoder stages map depth D→M; decoder stages are the mirror M→D
    (reference: source/autoencoder.cpp:100-118).
    """

    c: torch.Tensor
    b: torch.Tensor

    @property
    def m(self) -> int:
        return self.c.shape[0]

    @property
    def d(self) -> int:
        return self.c.shape[1]

    @property
    def nk(self) -> int:
        return self.c.shape[2]

    @property
    def nl(self) -> int:
        return self.c.shape[3]


@dataclasses.dataclass
class AEParams:
    """The full parameter tape: encoder stages then mirrored decoder stages.

    ``stages[i]`` for ``i < n/2`` are encoder convs; ``stages[n-1-i]`` is the
    decoder mirror of stage ``i`` (source/autoencoder.cpp:175, 138).
    """

    stages: Tuple[ConvStage, ...]

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def n_pairs(self) -> int:
        return len(self.stages) // 2

    def pair(self, n_l: int) -> tuple[ConvStage, ConvStage]:
        """Encoder stage ``n_l`` and its mirrored decoder stage."""
        return self.stages[n_l], self.stages[self.n_stages - 1 - n_l]

    def replace_pair(self, n_l: int, enc: ConvStage,
                     dec: ConvStage) -> "AEParams":
        stages = list(self.stages)
        stages[n_l] = enc
        stages[self.n_stages - 1 - n_l] = dec
        return AEParams(stages=tuple(stages))

    def leaves(self) -> list[torch.Tensor]:
        """The tensors in the JAX pytree's flatten order: ``c``, ``b`` of
        stage 0, then of stage 1, …"""
        return [t for st in self.stages for t in (st.c, st.b)]

    @classmethod
    def from_leaves(cls, leaves: Sequence[torch.Tensor]) -> "AEParams":
        """Inverse of :meth:`leaves`."""
        return cls(stages=tuple(ConvStage(c=leaves[i], b=leaves[i + 1])
                                for i in range(0, len(leaves), 2)))


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """Static shape info for one conv stage."""

    m: int
    d: int
    nk: int
    nl: int
    scale: int  # >0: downsample before conv (encoder); <0: upsample after (decoder)
    nx: int     # activation rows at this stage's conv input
    ny: int     # activation cols at this stage's conv input


@dataclasses.dataclass(frozen=True)
class NetSpec:
    """Hashable structural description of the whole net.

    Mirrors the reference's ``scale`` vector plus the implied activation
    shapes (source/autoencoder.cpp:109-120, 384-431).
    """

    nx: int
    ny: int
    d: int
    stages: Tuple[StageSpec, ...]

    @property
    def n_pairs(self) -> int:
        return len(self.stages) // 2

    @property
    def scales(self) -> Tuple[int, ...]:
        return tuple(s.scale for s in self.stages)

    def inner_shape(self) -> tuple[int, int, int]:
        """(depth, nx, ny) of the innermost (bottleneck) activation."""
        s = self.stages[self.n_pairs - 1]
        return s.m, s.nx, s.ny  # conv preserves spatial dims

    def add_pair(self, layer: LayerParams) -> "NetSpec":
        """Insert a new conv stage pair at the net midpoint ('n' key).

        The new stage reads the current innermost activation and pools by the
        new layer's scale (source/autoencoder.cpp:384-431).
        """
        n = self.n_pairs
        inner = self.stages[n - 1]
        d_in = inner.m
        nx_in = inner.nx  # innermost feature-map resolution
        ny_in = inner.ny
        sc = layer.scale
        _check_divisible(nx_in, ny_in, sc)
        enc = StageSpec(m=layer.depth, d=d_in, nk=layer.nk, nl=layer.nl,
                        scale=sc, nx=nx_in // sc, ny=ny_in // sc)
        dec = StageSpec(m=d_in, d=layer.depth, nk=layer.nk, nl=layer.nl,
                        scale=-sc, nx=nx_in // sc, ny=ny_in // sc)
        stages = self.stages[:n] + (enc, dec) + self.stages[n:]
        return dataclasses.replace(self, stages=stages)

    def drop_pair(self) -> "NetSpec":
        """Remove the innermost stage pair ('d' key, autoencoder.cpp:432-457)."""
        if self.n_pairs <= 1:
            raise ValueError("cannot drop the last stage pair")
        n = self.n_pairs
        stages = self.stages[: n - 1] + self.stages[n + 1:]
        return dataclasses.replace(self, stages=stages)


def _check_divisible(nx: int, ny: int, scale: int) -> None:
    if scale > 1 and (nx % scale or ny % scale):
        raise ValueError(
            f"pooling scale {scale} does not divide the activation size "
            f"{nx}x{ny}; the reference silently truncates here — choose a "
            f"resolution divisible by the product of all pooling scales")


def initial_spec(cfg: Config) -> NetSpec:
    """The 1-pair net built at startup (source/autoencoder.cpp:109-120)."""
    s = cfg.layer.scale
    _check_divisible(cfg.nx, cfg.ny, s)
    enc = StageSpec(m=cfg.layer.depth, d=cfg.d, nk=cfg.layer.nk,
                    nl=cfg.layer.nl, scale=s, nx=cfg.nx // s, ny=cfg.ny // s)
    dec = StageSpec(m=cfg.d, d=cfg.layer.depth, nk=cfg.layer.nk,
                    nl=cfg.layer.nl, scale=-s, nx=cfg.nx // s, ny=cfg.ny // s)
    return NetSpec(nx=cfg.nx, ny=cfg.ny, d=cfg.d, stages=(enc, dec))


def init_stage(gen: torch.Generator, spec: StageSpec, rmax: float, *,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cpu") -> ConvStage:
    """Uniform init in [-rmax, rmax] for kernels and biases.

    Reference: ``Init_conv`` (source/netlib.cpp:167-197).  ``rmax=0``
    zeros.  The draws come from ``gen`` (a CPU generator, so a seed gives
    the same weights whatever ``device`` they are placed on).
    """
    def uniform(*shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float64)
        return ((2.0 * u - 1.0) * rmax).to(dtype=dtype, device=device)
    c = uniform(spec.m, spec.d, spec.nk, spec.nl)
    b = uniform(spec.m)
    return ConvStage(c=c, b=b)


def init_params(gen: torch.Generator, spec: NetSpec, rmax: float, *,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu") -> AEParams:
    return AEParams(stages=tuple(
        init_stage(gen, s, rmax, dtype=dtype, device=device)
        for s in spec.stages))


def zeros_like_params(params: AEParams) -> AEParams:
    return AEParams.from_leaves([torch.zeros_like(t)
                                 for t in params.leaves()])


def spec_of(params: AEParams, nx: int, ny: int, d: int,
            scales: Tuple[int, ...]) -> NetSpec:
    """Rebuild a NetSpec from concrete params + scales (e.g. after load)."""
    stages = []
    cx, cy = nx, ny
    for st, sc in zip(params.stages, scales):
        if sc > 0:  # encoder: pool first
            cx, cy = cx // sc, cy // sc
        stages.append(StageSpec(m=st.m, d=st.d, nk=st.nk, nl=st.nl,
                                scale=sc, nx=cx, ny=cy))
        if sc < 0:  # decoder: upsample after conv
            cx, cy = cx * (-sc), cy * (-sc)
    return NetSpec(nx=nx, ny=ny, d=d, stages=tuple(stages))


@dataclasses.dataclass
class OptState:
    """Optimizer state for the inertia + adaptive-lr update.

    ``mom``  — previous applied update ``dw = w(t-1) - w(t-2)``
               (reference ``dc/df/db/dp``, autoencoder.cpp:102-104).
    ``prev_grad`` — previous raw gradient (reference ``ddc/ddf/...``,
               autoencoder.cpp:105-107), consumed by the adaptive-lr rule.
    """

    mom: AEParams
    prev_grad: AEParams


def init_opt_state(params: AEParams) -> OptState:
    return OptState(mom=zeros_like_params(params),
                    prev_grad=zeros_like_params(params))


def params_from_numpy(stages: Sequence[tuple[np.ndarray, np.ndarray]], *,
                      device: torch.device | str = "cpu") -> AEParams:
    """``[(c, b), ...]`` numpy arrays (e.g. a JAX ``AEParams`` read out with
    ``np.asarray``) → float32 :class:`AEParams` on ``device``."""
    return AEParams(stages=tuple(
        ConvStage(c=torch.tensor(np.asarray(c, np.float32), device=device),
                  b=torch.tensor(np.asarray(b, np.float32), device=device))
        for c, b in stages))


def params_to_numpy(params: AEParams) -> list[tuple[np.ndarray, np.ndarray]]:
    """Inverse of :func:`params_from_numpy`: ``[(c, b), ...]`` on the host."""
    return [(s.c.detach().cpu().numpy(), s.b.detach().cpu().numpy())
            for s in params.stages]


def opt_state_from_numpy(mom: Sequence[tuple[np.ndarray, np.ndarray]],
                         prev_grad: Sequence[tuple[np.ndarray, np.ndarray]],
                         *, device: torch.device | str = "cpu") -> OptState:
    """Momentum and previous-gradient ``[(c, b), ...]`` arrays (e.g. a JAX
    ``OptState`` read out with ``np.asarray``) → :class:`OptState`."""
    return OptState(mom=params_from_numpy(mom, device=device),
                    prev_grad=params_from_numpy(prev_grad, device=device))


def opt_state_to_numpy(opt: OptState):
    """Inverse of :func:`opt_state_from_numpy`: ``(mom, prev_grad)``."""
    return params_to_numpy(opt.mom), params_to_numpy(opt.prev_grad)
