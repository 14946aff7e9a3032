#!/usr/bin/env python3
"""Card check and times of the omega-space burst kernels K5-K8.

At ``chip_smoke.py``'s two burst inputs (the JAX benchmark's headline, one
[3, 256, 256] frame, W = 33,024; and the stream's pair-0 input, 128² b8 of
256² frames, W = 8,320), with float32 and with bf16 operands: each kernel
output by output against its plain version, at ``chip_smoke.py``'s
tolerance for that output (``omega_tols``; a row shows the output nearest
its tolerance), each kernel run three times and
compared bit for bit, then each kernel's device time from
``torch.profiler`` (its own grids; ``chip_smoke.py``'s ``device_ms``) and
CUDA events beside the plain version's device time.  K8 runs
``STREAM_CMP_ITERS`` iterations.  Prints the card's name and power limit,
one line a row, then one JSON line; exits 1 if a kernel disagrees or does
not repeat.

``--check`` skips the timing (a first call after a kernel change).
``--root`` imports ``spectralae_torch`` from another checkout (its kernels
are built there), so that two versions are compared within one run on one
card, for example a parent unpacked with ``git archive``::

    python scripts/torch_omega_bench.py
    python scripts/torch_omega_bench.py --root build/parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# every grid K5-K8 launch: the tensor-core sweep (K5-K7) and K8's; and
# those of a checkout from before K6 and K8 ran on it (``--root``)
GRIDS = ("::tc_sweep_kernel", "::tc_itergrid_kernel", "::sweep_kernel",
         "::reduce_kernel", "::itergrid_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout to import spectralae_torch from")
    ap.add_argument("--check", action="store_true",
                    help="hold the kernels against their plain versions "
                         "and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs
    from spectralae_torch.ops import burst_kernels as bk
    from spectralae_torch.train import fft_pallas as fp
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, ok = {}, True
    for label, x, out0, w in cs._omega_inputs(gen):
        s = fp._prepare(x, x, out0, w[0], True, torch.float32)
        M, D, nk, _ = w[0].shape
        cf = fp._stack(w[0], w[1], M * D, nk * nk)
        b, p = w[2], w[3]
        ops = (s.planes, s.basis, s.wv, cf, b)
        zeros = [torch.zeros_like(t) for t in (cf, b, p)]
        for variant in ("f32", "bf16"):
            bf16 = variant == "bf16"
            k = dict(s.consts, mxu_bf16=bf16)
            k5 = {n: k[n] for n in ("norm", "scale", "mxu_bf16")}
            k6 = {n: k[n] for n in ("norm", "inv_m", "inv_d", "mxu_bf16")}
            k8 = dict(k, iters=cs.STREAM_CMP_ITERS, lr_eff=0.02, alpha=0.9)
            calls = {
                "k5": (lambda: bk.grad_project(*ops, **k5),
                       lambda: bk.grad_project_plain(*ops, **k5)),
                "k6": (lambda: bk.respectra_conv(*ops, p, **k6),
                       lambda: bk.respectra_conv_plain(*ops, p, **k6)),
                "k7": (lambda: bk.fused_step(*ops, p, **k),
                       lambda: bk.fused_step_plain(*ops, p, **k)),
                "k8": (lambda: bk.itergrid(*ops, p, *zeros, **k8),
                       lambda: bk.itergrid_plain(*ops, p, *zeros, **k8))}
            for key, (kern, plain) in calls.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                tols = cs.omega_tols(key, bf16)
                held = {o: cs.rel_err(g.reshape(-1), v.reshape(-1))
                        for o, g, v in zip(cs.OMEGA_OUTPUTS[key], got, want)}
                worst = max(held, key=lambda o: held[o] / tols[o])
                row = {"rel": held[worst], "tol": tols[worst],
                       "worst_output": worst}
                flat = cs._flat(got)
                row["repeats"] = all(torch.equal(flat, cs._flat(kern()))
                                     for _ in range(2))
                ok &= row["repeats"]
                ok &= all(held[o] <= tols[o] for o in held)
                if not args.check:
                    for _ in range(2):   # a profile may drop the records
                        row["ms"] = cs.device_ms(kern, GRIDS)
                        if row["ms"] > 0:
                            break
                    row["events_ms"] = cs.cuda_ms(kern)
                    row["plain_ms"] = cs.device_ms(plain)
                rows[f"{label} {variant} {key}"] = row
                print(f"{label} {variant} {key}: " + ", ".join(
                    f"{n} {v:.4g}" if isinstance(v, float) else f"{n} {v}"
                    for n, v in row.items()), flush=True)
    print(json.dumps({"card": smi, "root": str(Path(args.root).resolve()),
                      "rows": rows}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
