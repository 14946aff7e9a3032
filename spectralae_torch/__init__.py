"""spectralae_torch — the spectral autoencoder in PyTorch, for NVIDIA Hopper.

A port of :mod:`spectralae` (the JAX package, which stays the reference).
Every module keeps its JAX counterpart's file path, public names and array
layouts (``[B, D, Nx, Ny]`` activations, ``[M, D, Nk, Nl]`` kernels,
``[..., Nx, Ny//2+1]`` complex64 spectra).  Plain tensor code is PyTorch;
the two kernels the serving forward needs are hand-written CUDA C++ under
``csrc/``, built with ``nvcc`` at first use (:mod:`spectralae_torch._kernels`).

This package never imports ``jax`` or ``spectralae``.
"""

__version__ = "0.1.0"
