#!/usr/bin/env python3
"""The fused y-DFT energy probe, as the port's CUDA kernel (P2).

The PyTorch counterpart of ``scripts/probe_fused_dft.py``: ``ydft_energy``
(``spectralae_torch/ops/probe_kernels.py``, ``csrc/probes.cu``) computes
``Σ_d Σ_rows Σ_ωy w(ωy)·|DFT_y(x)|²`` of ``x [D, nx, ny]`` from pixel rows,
the y-DFT a product with the ``[ny, nyr]`` cos/sin bases on the tensor
cores at a JAX precision tier (``"default"``: bf16 operands, ``"high"``:
bf16×3, ``"highest"``: bf16×6), and is held against the same energy
through ``torch.fft.rfft`` (``ref_energy``).

``--check`` runs the JAX probe's small case, ``x [3, 32, 48]`` with
``y_chunk=16``, at each tier, and asserts a relative error under the
tier's bound (``fft_kernels.p2_tier_tol``).  Without it, the script times
``[3, n, n]`` (default n = 2048): the ``torch.fft.rfft`` route (the JAX
probe's ``xla_rfft_y`` row), the kernel at each tier and the plain version
(two cuBLAS float32 products a chunk), each with its value, its error against
the rfft route and its mean ms over CUDA events, and says which tier, if
any, beats the rfft route.  Both run on the card unless ``--device cpu``
asks for the plain version on the CPU (float32 at every tier)::

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

# the card's peaks: the memory rate and the float32 rate outside the tensor
# cores (the tensor cores' bf16 rate: fft_kernels.design_tc_ms)
from benchmark.costs import FP32_FLOP_PER_S, HBM_BYTES_PER_S  # noqa: E402
from spectralae_torch.ops import fft_kernels as fk  # noqa: E402
from spectralae_torch.ops import probe_kernels as pk  # noqa: E402


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
    and beside it the matmul DFT's operations over that peak and, per tier,
    its bf16 passes over the tensor cores' peak (figures of the design)."""
    w = work(shape)
    t_bytes = w["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = w["flops"] / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "matmul_dft_flops": w["matmul_dft_flops"],
            "matmul_dft_ms": w["matmul_dft_flops"] / FP32_FLOP_PER_S * 1e3,
            "tensor_core_ms": {t: fk.design_tc_ms(w["matmul_dft_flops"], t)
                               for t in fk.TIERS}}


def check(device: str) -> float:
    """The JAX probe's ``--check`` case at each tier; returns the largest
    relative error."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 32, 48)).astype(np.float32))
    x = x.to(device)
    ref = float(pk.ref_energy(x))
    worst = 0.0
    for tier in fk.TIERS:
        got = float(pk.ydft_energy(x, y_chunk=16, precision=tier))
        rel = abs(got - ref) / abs(ref)
        tol = fk.p2_tier_tol(tier, x.numel())
        print(f"check on {device} ({tier}): got {got:.6g} ref {ref:.6g} rel "
              f"{rel:.2e}", flush=True)
        if rel >= tol:
            raise SystemExit(f"ydft_energy ({tier}) disagrees with the rfft "
                             f"route: rel {rel:.2e} >= {tol:g}")
        worst = max(worst, rel)
    print("OK", flush=True)
    return worst


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
          f"{b['matmul_dft_ms']:.4f} ms, on the tensor cores "
          + ", ".join(f"{t} {ms:.4f} ms" for t, ms in
                      b["tensor_core_ms"].items()), flush=True)
    routes = {"torch_rfft_y": lambda: pk.ref_energy(x)}
    for tier in fk.TIERS:
        routes[f"kernel_{tier}"] = (
            lambda tier=tier: pk.ydft_energy(x, precision=tier))
    routes["plain"] = lambda: pk.ydft_energy_plain(x)
    rows, ref = {}, None
    for name, fn in routes.items():
        v = float(fn())
        ref = v if ref is None else ref
        ms = _ms(fn, reps, device.startswith("cuda"))
        rel = abs(v - ref) / abs(ref)
        rows[name] = {"value": v, "rel": rel, "ms": ms}
        print(f"{name}: val {v:.6g} rel {rel:.2e} ms {ms:.4f}", flush=True)
    faster = [t for t in fk.TIERS
              if rows[f"kernel_{t}"]["ms"] < rows["torch_rfft_y"]["ms"]]
    print("tiers that beat the rfft route: "
          + (", ".join(faster) if faster else "none"), flush=True)
    rows.update(b)
    rows["faster_than_rfft"] = faster
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
