#!/usr/bin/env python3
"""Card times of the two tensor-core matmul-DFT kernels at each JAX tier.

Times the kernels of ``spectralae_torch`` at the shapes ``chip_smoke.py``
holds them at: the y-leaf (B5a, real) and the x-leaf (B5b) at 256² b8
frames (pair 0's [24, 128, 128] input), the complex y-leaf (B5e) at [12,
4096, 1024], the whole four-step transform at [3, 4096, 4096] and the
fused y-DFT energy (P2) at [3, 2048, 2048], each at "default", "high" and
"highest"; as device time from ``torch.profiler`` (``chip_smoke.py``'s
``device_ms``: the kernels' own time, whatever the host's pace) and as
CUDA events (the mean over the calls, host gaps included).  Prints the
card's name and power limit, then one JSON line.

``--root`` imports ``spectralae_torch`` from another checkout (its kernels
are built there), so that two versions are compared within one run on one
card, for example a parent unpacked with ``git archive``::

    python scripts/torch_dft_tiers_bench.py
    python scripts/torch_dft_tiers_bench.py --root build/parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

TIERS = ("default", "high", "highest")
ROOT = Path(__file__).resolve().parents[1]


def cases():
    """(name, function of the tier) at chip_smoke.py's shapes."""
    from spectralae_torch.ops import fft_kernels as fk
    from spectralae_torch.ops import probe_kernels as pk
    gen = torch.Generator(device="cuda").manual_seed(0)
    xb = torch.rand(24, 128, 128, device="cuda", generator=gen) * 255
    yr, yi = (a.reshape(-1, 128, fk._k1p(128))
              for a in fk.rfft_y_mixed_plain(xb))
    yr, yi = yr.contiguous(), yi.contiguous()
    n = 4096
    zr = torch.randn(12, n, n // 4, device="cuda", generator=gen)
    zi = torch.randn(12, n, n // 4, device="cuda", generator=gen)
    x4 = torch.rand(3, n, n, device="cuda", generator=gen) * 255
    xp = torch.randn(3, 2048, 2048, device="cuda", generator=gen)
    return [
        ("b5a y-leaf [24, 128, 128]", lambda p: fk._y_leaf(xb, None, p)),
        ("b5b x-leaf [96, 128, 24]",
         lambda p: fk.fft_x_mixed(yr, yi, precision=p)),
        ("b5e complex y-leaf [12, 4096, 1024]",
         lambda p: fk._y_leaf(zr, zi, p)),
        ("rfft2_mixed [3, 4096, 4096]",
         lambda p: fk.rfft2_mixed(x4, precision=p)),
        ("p2 ydft_energy [3, 2048, 2048]",
         lambda p: pk.ydft_energy(xp, precision=p)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout to import spectralae_torch from")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import spectralae_torch
    from chip_smoke import cuda_ms, device_ms
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    rows = {}
    for name, fn in cases():
        rows[name] = {t: {"device_ms": device_ms(lambda t=t: fn(t)),
                          "events_ms": cuda_ms(lambda t=t: fn(t))}
                      for t in TIERS}
        print(f"{name}: " + ", ".join(
            f"{t} {v['device_ms']:.4f} ms (events {v['events_ms']:.4f})"
            for t, v in rows[name].items()), flush=True)
    print(json.dumps({"root": str(Path(spectralae_torch.__file__).parents[1]),
                      "card": smi, "ms": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
