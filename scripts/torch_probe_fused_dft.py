#!/usr/bin/env python3
"""The fused y-DFT energy probe, as the port's CUDA kernel (P2).

The PyTorch counterpart of ``scripts/probe_fused_dft.py``: ``ydft_energy``
(``spectralae_torch/ops/probe_kernels.py``, ``csrc/probes.cu``) computes
``Σ_d Σ_rows Σ_ωy w(ωy)·|DFT_y(x)|²`` of ``x [D, nx, ny]`` from pixel rows,
the y-DFT a float32 product with the ``[ny, nyr]`` cos/sin bases, and is
held against the same energy through ``torch.fft.rfft`` (``ref_energy``).

``--check`` runs the JAX probe's small case, ``x [3, 32, 48]`` with
``y_chunk=16``, and asserts a relative error under 1e-5.  Without it, the
script times ``[3, n, n]`` (default n = 2048): the ``torch.fft.rfft`` route
(the JAX probe's ``xla_rfft_y`` row), the kernel at the ``"default"`` and
``"highest"`` tiers (both IEEE float32 here) and the plain version (two
cuBLAS float32 products), each with its value, its error against the rfft
route and its mean ms over CUDA events.  Both run on the card unless
``--device cpu`` asks for the plain version on the CPU::

    python scripts/torch_probe_fused_dft.py --check
    python scripts/torch_probe_fused_dft.py --check --device cpu
    python scripts/torch_probe_fused_dft.py --n 2048
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from spectralae_torch.ops import probe_kernels as pk  # noqa: E402

CHECK_TOL = 1e-5
# the card's peaks (NVIDIA's H100 SXM data sheet): the memory rate and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def work(shape) -> dict:
    """What the energy of ``x [D, nx, ny]`` needs at the least: ``x`` read
    once and the scalar written (bytes), and a real FFT of each row
    (2.5·ny·log2(ny) flops, half a complex FFT's 5·n·log2(n)) with 5 flops
    a bin for the weighted square (operations).  ``matmul_dft_flops`` is
    what the kernel's matmul DFT does instead, 4·D·nx·ny·nyr, a figure of
    the design and not a bound of the function."""
    d, nx, ny = shape
    nyr = ny // 2 + 1
    return {"bytes": 4.0 * (d * nx * ny + 1),
            "flops": d * nx * (2.5 * ny * math.log2(ny) + 5.0 * nyr),
            "matmul_dft_flops": 4.0 * d * nx * ny * nyr}


def bound(shape) -> dict:
    """The least time the card could take for the energy (the larger of the
    bytes over the memory rate and the operations over the float32 peak),
    and the matmul DFT's operations over that peak beside it."""
    w = work(shape)
    t_bytes = w["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = w["flops"] / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "matmul_dft_ms": w["matmul_dft_flops"] / FP32_FLOP_PER_S * 1e3}


def check(device: str) -> float:
    """The JAX probe's ``--check`` case; returns the relative error."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 32, 48)).astype(np.float32))
    x = x.to(device)
    got = float(pk.ydft_energy(x, y_chunk=16))
    ref = float(pk.ref_energy(x))
    rel = abs(got - ref) / abs(ref)
    print(f"check on {device}: got {got:.6g} ref {ref:.6g} rel {rel:.2e}",
          flush=True)
    if rel >= CHECK_TOL:
        raise SystemExit(f"ydft_energy disagrees with the rfft route: rel "
                         f"{rel:.2e} >= {CHECK_TOL:g}")
    print("OK", flush=True)
    return rel


def _ms(fn, reps: int, cuda: bool) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after warm-up: CUDA events
    on the card, the host clock on the CPU."""
    for _ in range(2):
        fn()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def timing(n: int, device: str, reps: int) -> dict:
    """Each route's value, error against the rfft route and mean ms at
    ``x [3, n, n]`` (seed 0)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, n, n)).astype(np.float32))
    x = x.to(device)
    b = bound(x.shape)
    print(f"{list(x.shape)} on {device}: bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}: x read once, or a real FFT a row at the "
          f"float32 peak); the matmul DFT's 4*D*nx*ny*nyr flops at that peak "
          f"{b['matmul_dft_ms']:.4f} ms", flush=True)
    routes = {
        "torch_rfft_y": lambda: pk.ref_energy(x),
        "kernel_default": lambda: pk.ydft_energy(x, precision="default"),
        "kernel_highest": lambda: pk.ydft_energy(x, precision="highest"),
        "plain": lambda: pk.ydft_energy_plain(x),
    }
    rows, ref = {}, None
    for name, fn in routes.items():
        v = float(fn())
        ref = v if ref is None else ref
        ms = _ms(fn, reps, device.startswith("cuda"))
        rel = abs(v - ref) / abs(ref)
        rows[name] = {"value": v, "rel": rel, "ms": ms}
        print(f"{name}: val {v:.6g} rel {rel:.2e} ms {ms:.4f}", flush=True)
    rows.update(b)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--check", action="store_true",
                    help="the small correctness case only")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain version)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    device = args.device
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("torch finds no CUDA device (pass --device cpu for the plain "
              "version)", file=sys.stderr)
        return 1
    if args.check:
        check(device)
        return 0
    if device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(smi, flush=True)
    print(json.dumps(timing(args.n, device, args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
