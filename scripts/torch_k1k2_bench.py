#!/usr/bin/env python3
"""Card check and times of K1 ``cmul_contract`` and K2 ``conv_valid``.

At every launch shape of a 256² batch-8 and a 1024² batch-4 train step of
the default 3-pair net (``chip_smoke.py``'s ``stage_shapes``), and of the
benchmark's two fft cells (the net at M = 50, 1024² batch 16; at M = 10,
1024² batch 64): K1's forward, input-spectrum gradient (dX) and
kernel-spectrum gradient (dC; p the transposed view gᵀ), with complex64
and with bf16 operands; at the 10-wide steps K2's forward at every stage
shape (routed to K2 by ``coord.conv2d`` or not) and its data-grad shapes.
Each launch is held against its plain version (``chip_smoke.py``'s
tolerances), run three times and compared bit for bit, K1's also against
the other of its two designs (lane and blocked, ``k1_plan``) bit for bit,
then timed: the kernel's own grids from ``torch.profiler``
(``chip_smoke.py``'s ``device_ms``), CUDA events, the library call
(``torch.einsum`` for K1, ``F.conv2d`` for K2, cuDNN without TF32) and the
bound (``k1_bound``, ``k2_bound``).  Prints the card's name and power
limit, each kernel instantiation's registers and spills from the build's
``-Xptxas=-v`` report, one line a row (K1's with the design its plan
took), the sums per train step, then one JSON line; exits 1 if a launch
disagrees or does not repeat.

``--check`` skips the timing (a first call after a kernel change).
``--sweep`` times each launch shape under other launch plans as well (K1:
the plan of the other design; where the lane design is taken, 1, 2 or 4
rows a thread and every channel group B allows; where the blocked one is,
its best four tiles, each with 4 or 8 values of k a stage and 2 or 3
buffers; K2: both tile widths and every channel group that divides M),
the plan's own beside the fastest, which is how the plans' thresholds
were chosen.
``--root`` imports ``spectralae_torch`` from another checkout (its kernels
are built there), so that two versions are compared within one run on one
card, for example a parent unpacked with ``git archive``::

    python scripts/torch_k1k2_bench.py
    python scripts/torch_k1k2_bench.py --root build/parent
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
GRIDS = {"k1": ("cmul_contract_kernel",), "k1bf": ("cmul_contract_kernel",),
         "k2": ("conv_valid_kernel",)}
# (frame side, batch, M): the 10-wide net's steps, then the benchmark's
# fft cells (K1 only)
SIZES = ((256, 8, 10), (1024, 4, 10))
CELLS = ((1024, 16, 50), (1024, 64, 10))


def stage_shapes(cs, nx: int, m: int):
    """(n, D, M) of each stage of the 3-pair net with M channels where the
    default net has 10."""
    return [(n, m if d == 10 else d, m if mm == 10 else mm)
            for n, d, mm in cs.stage_shapes(nx, 3)]


def k1_design(sk, a, k, b, w, vec, op_bytes) -> str:
    """The design K1's plan takes ("lane" in a checkout with only that)."""
    plan = sk.k1_plan(a, k, b, w, vec, *(
        (op_bytes,) if hasattr(sk, "K1BlockedPlan") else ()))
    return type(plan).__name__ == "K1BlockedPlan" and "blocked" or "lane"


def k1_other(sk, fn, a, k, b, w, vec, op_bytes, design):
    """``fn()`` with K1's plan forced to the design other than
    ``design``."""
    real = sk.k1_plan
    other = (sk._lane_plan(a, b, w, vec) if design == "blocked" else
             sk._blocked_plan(a, k, b, w, vec, op_bytes))
    sk.k1_plan = lambda *_, **__: other
    try:
        return fn()
    finally:
        sk.k1_plan = real


def blocked_key(plan) -> str:
    """A blocked plan's name in the sweep's lines."""
    return f"blocked {plan.na}x{plan.nb} kc{plan.kc} s{plan.stages}"


def k1_shape(label: str, n: int) -> tuple[int, int, int, int]:
    """(A, K, B, W) of a K1 case's label."""
    a, k, b = (int(v.split("=")[1]) for v in label.split()[1:4])
    return a, k, b, n * (n // 2 + 1)


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of every K1 and K2 instantiation, from
    nvcc's ``-Xptxas=-v`` report (empty when the library was reused)."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None or not any(k in entry for k in (
                "cmul_contract_kernel", "conv_valid_kernel")):
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


def k1_cases(cs, sk, gen, n, batch, d, m, bf16):
    """K1's three launches of one stage: (part, label, call kwargs, p, q,
    bound, library)."""
    nyr = n // 2 + 1
    w = n * nyr
    X = torch.fft.rfft2(torch.randn(batch, d, n, n, device="cuda",
                                    generator=gen)).reshape(batch, d, w)
    C = torch.randn(m, d, w, dtype=torch.complex64, device="cuda",
                    generator=gen)
    b = torch.randn(m, device="cuda", generator=gen)
    g = torch.randn(batch, m, w, dtype=torch.complex64, device="cuda",
                    generator=gen)
    ob = 4 if bf16 else 8
    if bf16:
        xs, gp = sk.bf16_planes(X, 1.0 / m), sk.bf16_planes(g)
        fwd = (xs, sk.bf16_planes(C).transpose(0, 1),
               dict(bias=b, bias_scale=float(n * n)))
        dx = (gp, sk.bf16_planes(C), dict(p_scale=1.0 / m, conj_q=True))
        dc = (gp.transpose(0, 1), xs, dict(conj_q=True))
    else:
        fwd = (X, C.transpose(0, 1),
               dict(p_scale=1.0 / m, bias=b, bias_scale=float(n * n)))
        dx = (g, C, dict(p_scale=1.0 / m, conj_q=True))
        dc = (g.transpose(0, 1), X, dict(p_scale=1.0 / m, conj_q=True))
    out = []
    for part, (p, q, kw), shape in (
            ("fwd", fwd, (batch, d, m)), ("dX", dx, (batch, m, d)),
            ("dC", dc, (m, batch, d))):
        lib = None
        if not bf16:
            q_lib = q.conj() if kw.get("conj_q") else q
            lib = (lambda p=p, q_lib=q_lib:
                   torch.einsum("akw,kbw->abw", p, q_lib))
        out.append((part, f"{part} A={shape[0]} K={shape[1]} B={shape[2]}",
                    (lambda p=p, q=q, kw=kw: sk.cmul_contract(p, q, **kw)),
                    (lambda p=p, q=q, kw=kw:
                     sk.cmul_contract_plain(p, q, **kw)),
                    cs.k1_bound(*shape, w, bias="bias" in kw, op_bytes=ob),
                    lib))
    return out


def k2_cases(cs, ck, gen, n, batch, d, m):
    """K2's forward and data grad at one stage shape."""
    import torch.nn.functional as F
    xpad = torch.randn(batch, d, n + 4, n + 4, device="cuda", generator=gen)
    wt = torch.randn(m, d, 5, 5, device="cuda", generator=gen)
    dy_pad = torch.randn(batch, m, n + 8, n + 8, device="cuda",
                         generator=gen)
    wtt = torch.randn(d, m, 5, 5, device="cuda", generator=gen)
    routed = "routed" if m * d <= 64 else "not routed"
    return [
        ("fwd", f"fwd {d}->{m} at {n + 4}^2 ({routed})",
         lambda: ck.conv_valid(xpad, wt),
         lambda: ck.conv_valid_plain(xpad.double(), wt.double()),
         cs.k2_bound(batch, d, m, n + 4, n + 4, 5, 5),
         lambda: F.conv2d(xpad, wt)),
        ("dx", f"data grad {m}->{d} at {n + 8}^2",
         lambda: ck.conv_valid(dy_pad, wtt),
         lambda: ck.conv_valid_plain(dy_pad.double(), wtt.double()),
         cs.k2_bound(batch, m, d, n + 8, n + 8, 5, 5),
         lambda: F.conv2d(dy_pad, wtt))]


def sweep(cs, sk, ck, gen) -> None:
    """Each launch shape of every step under other launch plans: one line
    a shape, the plan's time, then every plan tried, fastest first."""
    real_k1, real_k2 = sk.k1_plan, ck.k2_plan

    def timed(fn, plan, kern):
        sk.k1_plan = lambda *_, **__: plan
        try:
            return cs.device_ms(fn, GRIDS[kern])
        finally:
            sk.k1_plan = real_k1

    for nx, batch, mm in SIZES + CELLS:
        for n, d, m in sorted(set(stage_shapes(cs, nx, mm))):
            for bf16 in (False, True):
                kern, vec, ob = ("k1bf", 4, 4) if bf16 else ("k1", 2, 8)
                for part, label, fn, _, _, _ in k1_cases(cs, sk, gen, n,
                                                         batch, d, m, bf16):
                    a, k, b, w = k1_shape(label, n)
                    plan = real_k1(a, k, b, w, vec, ob)
                    lane = sk._lane_plan(a, b, w, vec)
                    tried = {"lane": timed(fn, lane, kern)}
                    own = sk._blocked_plan(a, k, b, w, vec, ob)
                    tried[blocked_key(own)] = timed(fn, own, kern)
                    if isinstance(plan, sk.K1Plan):
                        for rows in sorted({1, 2, 4, plan.rows}):
                            for group in range(1, min(b, 8) + 1):
                                if rows > a or b % group:
                                    continue
                                tried[f"lane r{rows} g{group}"] = timed(
                                    fn, sk.K1Plan(plan.vec, group, rows,
                                                  plan.grid), kern)
                    else:
                        tiles = list(dict.fromkeys(
                            (p.na, p.nb) for p in sk.k1_blocked_plans(
                                a, k, b, w, vec, ob)))[:4]
                        for (na, nb), kc, ring in itertools.product(
                                tiles, (4, 8), (2, 3)):
                            p = sk.k1_blocked_plan_of(a, k, b, w, vec, ob,
                                                      na, nb, kc, ring)
                            if (p.smem <= sk._BLOCK_SMEM
                                    and blocked_key(p) not in tried):
                                tried[blocked_key(p)] = timed(fn, p, kern)
                    design = ("lane" if isinstance(plan, sk.K1Plan)
                              else "blocked")
                    mine = tried["lane" if design == "lane"
                                 else blocked_key(own)]
                    print(f"sweep {nx}^2 b{batch} M{mm} {kern} {n}^2 "
                          f"{label}: plan {design} {mine:.4f}; " + ", ".join(
                              f"{key} {t:.4f}" for key, t in sorted(
                                  tried.items(), key=lambda i: i[1])),
                          flush=True)
            if (nx, batch, mm) in CELLS:
                continue
            for part, label, fn, _, _, _ in k2_cases(cs, ck, gen, n, batch,
                                                     d, m):
                dd, mm2 = (d, m) if part == "fwd" else (m, d)
                hp = n + (4 if part == "fwd" else 8)
                plan = real_k2(batch, dd, mm2, hp, hp, 5, 5)
                tried = {}
                for tx in (8, 16):
                    for mb in range(1, min(mm2, 16) + 1):
                        if mm2 % mb and mb != plan.mb:
                            continue
                        ck.k2_plan = (lambda *_, p=ck.K2Plan(
                            tx, plan.ty, mb, 0, plan.grid): p)
                        try:
                            tried[tx, mb] = cs.device_ms(fn, GRIDS["k2"])
                        finally:
                            ck.k2_plan = real_k2
                own = tried[plan.tx, plan.mb]
                print(f"sweep {nx}^2 b{batch} k2 {n}^2 {label}: plan tx "
                      f"{plan.tx} mb {plan.mb} {own:.4f}; " + ", ".join(
                          f"tx{t} mb{b} {v:.4f}" for (t, b), v in sorted(
                              tried.items(), key=lambda i: i[1])),
                      flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout to import spectralae_torch from")
    ap.add_argument("--check", action="store_true",
                    help="hold the kernels against their plain versions "
                         "and stop")
    ap.add_argument("--sweep", action="store_true",
                    help="time every launch shape under other launch "
                         "plans too, and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs
    from spectralae_torch import _kernels
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import spectral_kernels as sk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    build = _kernels.build()
    ptxas = ptxas_report(build.log)
    for kern in ("cmul_contract_kernel", "conv_valid_kernel"):
        ents = {e: r for e, r in ptxas.items() if kern in e}
        spilled = {e: r["spill"] for e, r in ents.items() if r.get("spill")}
        print(f"ptxas {kern}: {len(ents)} instantiations, registers "
              f"{min((r.get('regs', 0) for r in ents.values()), default=0)}"
              f"-{max((r.get('regs', 0) for r in ents.values()), default=0)}"
              f", spill bytes {sum(spilled.values())}", flush=True)
        for e in sorted(spilled):
            # the template arguments of the mangled name
            targs = re.search(r"kernelI(.*?)EEv", e)
            print(f"  spills: {targs.group(1) if targs else e} "
                  f"{ents[e]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.sweep:
        sweep(cs, sk, ck, gen)
        return 0
    rows, ok, steps = {}, True, {}
    two = hasattr(sk, "K1BlockedPlan")    # this checkout has both designs
    for nx, batch, mm in SIZES + CELLS:
        stages = stage_shapes(cs, nx, mm)
        cell = (nx, batch, mm) in CELLS
        size = f"{nx}^2 b{batch}" + (f" M{mm}" if cell else "")
        timed = {}
        for n, d, m in sorted(set(stages)):
            cases = [("k1", c) for c in k1_cases(cs, sk, gen, n, batch, d, m,
                                                 False)]
            cases += [("k1bf", c) for c in k1_cases(cs, sk, gen, n, batch, d,
                                                    m, True)]
            if not cell:
                cases += [("k2", c) for c in k2_cases(cs, ck, gen, n, batch,
                                                      d, m)]
            for kern, (part, label, fn, plain, bound, lib) in cases:
                got = fn()
                want = plain()
                tol = {"k1": cs.TOL_K1, "k1bf": cs.TOL_K1_BF16,
                       "k2": cs.TOL_K2}[kern]
                row = {"rel": cs.rel_err(got, want), "tol": tol,
                       "repeats": all(torch.equal(got, fn())
                                      for _ in range(2))}
                ok &= row["repeats"] and row["rel"] <= tol
                if kern != "k2":
                    vec, ob = (4, 4) if kern == "k1bf" else (2, 8)
                    shape = k1_shape(label, n)
                    row["design"] = k1_design(sk, *shape, vec, ob)
                    if two:
                        other = k1_other(sk, fn, *shape, vec, ob,
                                         row["design"])
                        row["designs_equal"] = torch.equal(
                            torch.view_as_real(got).view(torch.int32),
                            torch.view_as_real(other).view(torch.int32))
                        ok &= row["designs_equal"]
                del got, want
                if not args.check:
                    for _ in range(2):   # a profile may drop the records
                        row["ms"] = cs.device_ms(fn, GRIDS[kern])
                        if row["ms"] > 0:
                            break
                    row["events_ms"] = cs.cuda_ms(fn)
                    row["library_ms"] = (None if lib is None
                                         else cs.device_ms(lib))
                    row["bound_ms"], row["bound_by"] = bound
                    row["over_bound"] = row["ms"] / row["bound_ms"]
                name = f"{size} {kern} {n}^2 {label}"
                rows[name] = row
                timed[kern, n, d, m, part] = row
                print(f"{name}: " + ", ".join(
                    f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in row.items()), flush=True)
        if args.check:
            continue
        # one train step: every stage's forward, dC, and dX past stage 0 (K1,
        # fft domain); the routed forwards (K2, coord domain)
        for kern in ("k1", "k1bf") + (() if cell else ("k2",)):
            tot = {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                   "blocked": 0}
            for s, (n, d, m) in enumerate(stages):
                parts = (("fwd", "dC") + (("dX",) if s else ())
                         if kern != "k2" else
                         ("fwd",) if m * d <= 64 else ())
                for part in parts:
                    r = timed[kern, n, d, m, part]
                    tot["ms"] += r["ms"]
                    tot["bound_ms"] += r["bound_ms"]
                    tot["blocked"] += r.get("design") == "blocked"
                    tot["library_ms"] = (None if r["library_ms"] is None
                                         or tot["library_ms"] is None
                                         else tot["library_ms"]
                                         + r["library_ms"])
            steps[f"{size} {kern}"] = tot
            print(f"per {size} step {kern}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in tot.items()), flush=True)
    print(json.dumps({"card": smi, "root": str(Path(args.root).resolve()),
                      "ok": ok, "ptxas": ptxas, "steps": steps,
                      "rows": rows}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
