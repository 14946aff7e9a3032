#!/usr/bin/env python3
"""The three Mosaic feature probes, as the port's CUDA kernels (P1).

The PyTorch counterpart of ``scripts/probe_mosaic_features.py``: the same
three tiny kernels, each held against numpy on the JAX probe's inputs —

  1. ``lane_strided``:    ``2·x[:, 1::4]`` of an ``[8, 512]`` tile;
  2. ``sublane_strided``: ``2·x[1::4, :]`` of a ``[512, 128]`` tile;
  3. ``middle_store``:    ``out[k] = x·(k+1)``, k < 4, into ``[4, 128, 128]``

(``spectralae_torch/ops/probe_kernels.py``, ``csrc/probes.cu``).  Each
prints ``name: OK maxerr=0.0`` (the results are exact), ``VALUE-FAIL`` or
``FAIL`` with the error; the exit code is 1 if any case did not pass::

    python scripts/torch_probe_mosaic_features.py              # the card
    python scripts/torch_probe_mosaic_features.py --device cpu # plain versions
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from spectralae_torch.ops import probe_kernels as pk  # noqa: E402


def _arange(rows: int, cols: int) -> np.ndarray:
    return np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)


# name -> (wrapper, input, numpy reference of the output)
CASES = {
    "lane_strided": (pk.lane_strided, _arange(8, 512),
                     lambda x: x[:, 1::4] * 2.0),
    "sublane_strided": (pk.sublane_strided, _arange(512, 128),
                        lambda x: x[1::4, :] * 2.0),
    "middle_store": (pk.middle_store, _arange(128, 128),
                     lambda x: x[None] * np.arange(
                         1, 5, dtype=np.float32)[:, None, None]),
}


def run_case(name: str, device: str) -> tuple[bool, str]:
    """Run one probe on ``device``; (exact against numpy, the line)."""
    fn, x, ref = CASES[name]
    try:
        out = fn(torch.from_numpy(x).to(device))
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        want = ref(x)
        if tuple(out.shape) != want.shape:
            return False, (f"{name}: VALUE-FAIL shape {tuple(out.shape)}, "
                           f"want {want.shape}")
        err = float(np.max(np.abs(out.cpu().numpy() - want)))
        ok = err == 0.0
        return ok, f"{name}: {'OK' if ok else 'VALUE-FAIL'} maxerr={err}"
    except Exception as e:  # noqa: BLE001 — each case reports its own fault
        msg = str(e).replace("\n", " | ")[:300]
        return False, f"{name}: FAIL {type(e).__name__}: {msg}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("torch finds no CUDA device (pass --device cpu for the plain "
              "versions)", file=sys.stderr)
        return 1
    ok = True
    for name in CASES:
        passed, line = run_case(name, args.device)
        print(line, flush=True)
        ok &= passed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
