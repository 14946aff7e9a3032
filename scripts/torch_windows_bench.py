#!/usr/bin/env python3
"""Card check and times of K3 ``corr_pair_windows`` and K4 ``anchor_windows``.

At the burst precompute's shapes (``chip_smoke.py``'s ``WINDOW_SIZES``:
pair 0's input of the default net at 128² batch 8, 512² batch 4 and 1024²
batch 1): K3's two launches of one precompute (XX: Z is X at ±4h; EG: the
2·D error planes at ±2h), K4 with the float32 and the bf16 signal, and K4
on the four-step FFT's mixed planes (float32 and bf16, gathered to natural
order).  Each launch is held against its plain version
(``chip_smoke.TOL_WINDOWS``), run three times and compared bit for bit,
then timed: the kernel's own grids from ``torch.profiler``
(``chip_smoke.py``'s ``device_ms``), CUDA events, the plain version, K3's
library call (one ``torch.einsum`` over complex bases, as
``chip_smoke.py`` times it) and the bound (``k3_bound``, ``k4_bound``).
Prints the card's name and power limit, each instantiation's registers and
spills from the build's ``-Xptxas=-v`` report, one line a row with the
launch plan (``window_kernels.window_plan``), then one JSON line; exits 1
if a launch disagrees or does not repeat.

``--check`` skips the timing (a first call after a kernel change).
``--sweep`` times K3 and K4 (float32 signal) at each size under other
tilings as well (rows, batches, ω_y chunk and step), the plan's own beside
the fastest, which is how the plan's choices were made.
``--root`` imports ``spectralae_torch`` from another checkout (its kernels
are built there), so that two versions are compared within one run on one
card, for example a parent unpacked with ``git archive``::

    python scripts/torch_windows_bench.py
    python scripts/torch_windows_bench.py --root build/parent
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("window_rows_kernel", "window_reduce_kernel", "anchor_taps_kernel")


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of every K3/K4 instantiation, from nvcc's
    ``-Xptxas=-v`` report (empty when the library was reused)."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None or not any(k in entry for k in KERNELS):
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(entry, {})["stack"] = int(m.group(1))
            out.setdefault(entry, {})["spill"] = int(m.group(2)) + int(
                m.group(3))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(entry, {})["spill"] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(entry, {})["regs"] = int(m.group(1))
    return out


def cases(cs, wk, fk, gen, frames: int, batch: int):
    """(kernel, label, call, plain, bound, library, plan args) at one size:
    K3 xx and eg, K4 float32 and bf16 signal, K4 on mixed planes."""
    from spectralae_torch.train import fft_corr
    m, d, nk = 10, 3, 5
    c, f = ((torch.rand(*shape, device="cuda", generator=gen) - 0.5)
            for shape in ((m, d, nk, nk), (d, m, nk, nk)))
    taps = fft_corr._composed_taps(c, f, fft_corr._maps_on(nk, nk, c.device),
                                   d, m, nk * nk)
    nk2 = taps.shape[-1]
    h2, s1 = nk2 // 2, 1.0 / (m * d)
    n = frames // 2
    x = torch.rand(batch, d, n, n, device="cuda", generator=gen) * 255
    X = torch.fft.rfft2(x)
    Z = torch.fft.rfft2(torch.randn(batch, 2 * d, n, n, device="cuda",
                                    generator=gen) * 50)
    out = []
    for variant, Zs, h in (("xx", X, 2 * h2), ("eg", Z, h2)):
        bxc, bxs, byc, bys = (torch.as_tensor(a, device="cuda")
                              for a in wk.dft.lag_basis(n, n, h, h))
        ex, ey = torch.complex(bxc, bxs), torch.complex(byc, bys)
        out.append((
            "k3", f"K3 {variant} D={d} E={Zs.shape[1]} +-{h}",
            lambda Zs=Zs, h=h: wk.corr_pair_windows(X, Zs, n, n, h, h),
            lambda Zs=Zs, h=h: wk.corr_pair_windows_plain(X, Zs, n, n, h, h),
            cs.k3_bound(batch, d, Zs.shape[1], n, h, Zs is X),
            lambda Zs=Zs, ex=ex, ey=ey: torch.einsum(
                "bdxy,bexy,xu,yv->deuv", X.conj(), Zs, ex, ey).real / batch,
            (False, batch, d, Zs.shape[1], n, n // 2 + 1, h, h, Zs is X)))
    for variant, sd in (("f32", None), ("bf16", torch.bfloat16)):
        out.append((
            "k4", f"K4 {variant} signal D={d} taps {nk2}x{nk2}",
            lambda sd=sd: wk.anchor_windows(X, taps, n, n, h2, h2, s1,
                                            signal_dtype=sd),
            lambda sd=sd: wk.anchor_windows_plain(X, taps, n, n, h2, h2, s1,
                                                  signal_dtype=sd),
            cs.k4_bound(batch, d, n, nk2, sd is not None), None,
            (True, batch, d, d, n, n // 2 + 1, h2, h2, False)))
    for variant, od in (("f32", None), ("bf16", torch.bfloat16)):
        planes = fk.rfft2_mixed(x, precision="high", out_dtype=od)
        out.append((
            "k4", f"K4 mixed {variant} planes D={d} taps {nk2}x{nk2}",
            lambda planes=planes: wk.anchor_windows(planes, taps, n, n, h2,
                                                    h2, s1, mixed=True),
            lambda planes=planes: wk.anchor_windows_plain(
                planes, taps, n, n, h2, h2, s1, mixed=True),
            cs.k4_bound(batch, d, n, nk2, od is not None), None,
            (True, batch, d, d, n, n // 2 + 1, h2, h2, False)))
    return out


def flat(out) -> torch.Tensor:
    return (torch.cat([o.reshape(-1) for o in out])
            if isinstance(out, tuple) else out)


def grid_ms(cs, fn, calls: int = 10) -> float:
    """Device ms of the K3/K4 grids of one ``fn()`` (a profile of
    ``calls`` calls)."""
    return sum(ms * k for key, ms, k, _ in cs.device_ops(fn, calls)
               if any(n in key for n in KERNELS))


def sweep(cs, wk, fk, gen) -> None:
    """K3 and K4 (float32 signal) under other tilings: one line a case, the
    plan's time, then every tiling tried, fastest first."""
    real = wk.window_plan
    for frames, batch in cs.WINDOW_SIZES:
        for kern, label, fn, _, _, _, pargs in cases(cs, wk, fk, gen, frames,
                                                     batch)[:3]:
            anchor, B, D, E, nx, nyr, hx, hy, same = pargs
            plan = real(*pargs)
            tried = {}
            chunk_sizes = sorted({-(-nyr // c) for c in
                                  (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48)
                                  if -(-nyr // c) >= 4} | {plan.ychunk})
            bsizes = sorted({-(-B // 2 ** k) for k in range(4)})
            for rows, nb, yc, yt in itertools.product(
                    (8, 16), bsizes, chunk_sizes, (4, 8, 16)):
                if yt > 2 * yc or nb * yt > 64:
                    continue
                try:
                    p = wk.plan_of(anchor, B, D, E, nx, nyr, hx, hy, same,
                                   rows, nb, yc, yt)
                except ValueError:
                    continue
                blocks = p.grid[0] * p.grid[1] * p.grid[2]
                if not 132 <= blocks <= 2048:
                    continue
                wk.window_plan = lambda *_, p=p: p
                try:
                    tried[rows, nb, yc, yt] = grid_ms(cs, fn)
                finally:
                    wk.window_plan = real
            own = grid_ms(cs, fn)
            best = sorted(tried.items(), key=lambda i: i[1])
            print(f"sweep {frames}^2 frames b{batch} {label}: plan r"
                  f"{plan.rows} b{plan.batches} c{plan.ychunk} t{plan.ytile}"
                  f" {own:.4f}; " + ", ".join(
                      f"r{r} b{b} c{c} t{t} {v:.4f}"
                      for (r, b, c, t), v in best[:12]), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout to import spectralae_torch from")
    ap.add_argument("--check", action="store_true",
                    help="hold the kernels against their plain versions "
                         "and stop")
    ap.add_argument("--sweep", action="store_true",
                    help="time K3 and K4 under other tilings too, and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs
    from spectralae_torch import _kernels
    from spectralae_torch.ops import fft_kernels as fk
    from spectralae_torch.ops import window_kernels as wk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    build = _kernels.build()
    ptxas = ptxas_report(build.log)
    for e, r in sorted(ptxas.items()):
        targs = re.search(r"(window_\w+_kernel|anchor_taps_kernel)I?(.*?)"
                          r"(EEv|Ev|$)", e)
        print(f"ptxas {targs.group(1) + ' ' + targs.group(2) if targs else e}"
              f": {r.get('regs', 0)} registers, {r.get('spill', 0)} bytes "
              f"of spills, {r.get('stack', 0)} bytes of stack", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.sweep:
        sweep(cs, wk, fk, gen)
        return 0
    rows, ok = {}, True
    for frames, batch in cs.WINDOW_SIZES:
        for kern, label, fn, plain, bound, lib, pargs in cases(
                cs, wk, fk, gen, frames, batch):
            runs = [flat(fn()) for _ in range(3)]
            want = flat(plain())
            row = {"rel": cs.rel_err(runs[0], want), "tol": cs.TOL_WINDOWS,
                   "repeats": all(torch.equal(runs[0], r) for r in runs[1:])}
            ok &= row["repeats"] and row["rel"] <= cs.TOL_WINDOWS
            if hasattr(wk, "window_plan"):
                p = wk.window_plan(*pargs)
                row["plan"] = (f"r{p.rows} b{p.batches} c{p.ychunk} "
                               f"t{p.ytile} {p.threads}thr grid {p.grid}")
            if not args.check:
                for _ in range(2):   # a profile may drop the records
                    row["ms"] = cs.device_ms(fn, KERNELS)
                    if row["ms"] > 0:
                        break
                row["grids_ms"] = {n: round(cs.device_ms(fn, (n,)), 5)
                                   for n in KERNELS}
                row["events_ms"] = cs.cuda_ms(fn)
                row["plain_ms"] = cs.device_ms(plain)
                row["library_ms"] = None if lib is None else cs.device_ms(lib)
                row["bound_ms"], row["bound_by"] = bound
            name = f"{frames}^2 frames b{batch} {label}"
            rows[name] = row
            print(f"{name}: " + ", ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
        if not args.check:
            k3 = [r for n, r in rows.items()
                  if n.startswith(f"{frames}^2") and " K3 " in n]
            print(f"per precompute at {frames}^2 frames, K3's two launches: "
                  f"ms {sum(r['ms'] for r in k3):.4f}, library "
                  f"{sum(r['library_ms'] for r in k3):.4f}, bound "
                  f"{sum(r['bound_ms'] for r in k3):.4f}", flush=True)
    print(json.dumps({"card": smi, "root": str(Path(args.root).resolve()),
                      "ok": ok, "ptxas": ptxas, "rows": rows}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
