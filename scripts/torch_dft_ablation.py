#!/usr/bin/env python3
"""Where the tensor-core matmul-DFT kernels spend their time: ablations.

Builds copies of this checkout's ``spectralae_torch`` under
``build/ablation/<variant>/``, each with one change to the kernels'
sources, and times each copy with ``scripts/torch_dft_tiers_bench.py``
(one process a copy, all on one card):

- ``as-is``: the sources unchanged;
- ``products-only``: every chunk's products on the first chunk's staged
  operands (no loads, no staging after the first chunk): what the tensor
  cores take reading their operands from shared memory;
- ``staging-only``: every chunk staged and no products issued: what the
  loads, the butterfly, the split and the stores take.

The results of the last two are wrong by design; only their times mean
something.  Run on the card::

    python scripts/torch_dft_ablation.py
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablation"

# (file under csrc/, text, replacement) by variant
PATCHES = {
    "as-is": [],
    "products-only": [
        # the leaf: stage the first chunk only, load nothing after it
        ("rfft2_mixed.cu",
         "    // P = twiddled butterfly of this chunk, its pieces into the A "
         "tiles\n", "    if (c == 0) {\n"),
        ("rfft2_mixed.cu",
         "    wg::fence_stores();\n    __syncthreads();\n    // warpgroup g",
         "    }\n    wg::fence_stores();\n    __syncthreads();\n"
         "    // warpgroup g"),
        ("rfft2_mixed.cu", "    if (c + 1 < nc)\n      load_stage<CPLX, NP>(",
         "    if (false)\n      load_stage<CPLX, NP>("),
        # the sweep: the same
        ("probes.cu", "    if (c + 1 < nc) {\n      __syncthreads();",
         "    if (false) {\n      __syncthreads();"),
        ("probes.cu", "      bases(c + 1);\n", "")],
    "staging-only": [
        ("wgmma.cuh", "  for (int ks = 0; ks < kK / 16; ++ks)\n",
         "  for (int ks = 0; ks < 0; ++ks)\n")],
}


def make(variant: str) -> Path:
    """The patched copy of the package; fails if a patch does not apply."""
    root = OUT / variant
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / "spectralae_torch", root / "spectralae_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, old, new in PATCHES[variant]:
        path = root / "spectralae_torch" / "csrc" / name
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{variant}: {name} has no {old.strip()!r}")
        path.write_text(text.replace(old, new))
    return root


def main() -> int:
    roots = {v: make(v) for v in PATCHES}
    bench = ROOT / "scripts" / "torch_dft_tiers_bench.py"
    rc = 0
    for variant, root in roots.items():
        print(f"== {variant}", flush=True)
        rc |= subprocess.run([sys.executable, str(bench), "--root",
                              str(root)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
