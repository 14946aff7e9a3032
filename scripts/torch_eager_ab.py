#!/usr/bin/env python3
"""Checkouts of the port against each other on one card: the eager forward
and the float32 train step, the checkouts taken in turns.

The calls, on the default 3-pair net (BASELINE.md; weights from seed 0,
frames uniform in [0, 255) from seed 1):

- the forward, fft and coord (``tap_mode="ref_gpu"``, the serving path's
  window) under ``torch.inference_mode()``, at 256^2 b8 and 1024^2 b4;
- the float32 train step (``train.modern.train_step``), fft and coord, at
  the same sizes.

Each checkout's package is imported under a name of its own
(``ab_<NAME>``; the package imports itself only relatively).  By default
one process holds them all, so every reading of a round shares the host's
state; ``--processes`` runs each checkout in a process of its own a
round instead, which shows how far the host's pace moves between
processes.  The kernels are built once into one build directory (the
library's name hashes its sources).  In one process, a checkout whose
kernel modules register their operators through ``_kernels.operator`` is
also taken as ``<NAME>+operators``: every K1 and K2 launch through the
``torch.library`` dispatcher, as ``torch.export`` records them.  Two
checkouts that both register the operators cannot share a process.

For each call and checkout, a round takes three loops of REPS calls after
three untimed ones: host ms per call from the first call to the
synchronisation after the last, and enqueue ms from the first call to the
return of the last (the host's own cost where the device keeps up; a
device-bound call may block on the launch queue), each the median of the
three.  Rounds alternate the order of the checkouts (A B, B A, ...).  The
profiler's device time over REPS calls is taken once a process.  Then,
for a checkout with operators, enqueue µs per launch of each operator
against its CUDA kernel called directly, in turns (200 launches a loop,
20 loops), K1 at the 256^2 b8 fft forward's stage-0 shape and K2 at the
1024^2 b4 coord forward's.

Prints the card's name and power limit, a line per call with every
reading, and as its last line one JSON object with the readings, the
medians and each median's ratio to the first checkout's (also written to
``chiprun_out/eager_ab.json``)::

    python scripts/torch_eager_ab.py parent=/path/to/parent change=. \\
        [--rounds 8] [--processes]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BUILD_DIR = ROOT / "build" / "spectralae_torch"
REPS = 20
SIZES = ((256, 8), (1024, 4))


def load(checkout: Path, alias: str) -> dict:
    """The modules of ``checkout``'s package, imported as ``alias``, with
    its kernels built."""
    pkg = checkout / "spectralae_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    m = {name.rsplit(".", 1)[-1]: importlib.import_module(
        f"{alias}.{name}") for name in (
            "_kernels", "core.config", "core.types", "model.autoencoder",
            "train.modern", "ops.spectral_kernels", "ops.coord_kernels")}
    m["_kernels"].BUILD_DIR = BUILD_DIR
    m["_kernels"].build()
    return m


def has_operators(m: dict) -> bool:
    return hasattr(m["_kernels"], "operator")


@contextlib.contextmanager
def through_operators(m: dict):
    """Every K1 and K2 launch of the checkout ``m`` through its operator:
    the eager calls' kernels by device (``_kernels.operator``) replaced by
    the operator itself."""
    calls = (m["spectral_kernels"]._cmul_contract,
             m["coord_kernels"]._conv_valid)
    real = [dict(call.kernels) for call in calls]
    for call in calls:
        call.kernels.update(cpu=call.op, cuda=call.op)
    try:
        yield
    finally:
        for call, kernels in zip(calls, real):
            call.kernels.update(kernels)


def host_ms(fn, reps: int = REPS, loops: int = 3) -> tuple[float, float]:
    """(host ms, enqueue ms) per call of ``fn``, medians over ``loops``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wall, queued = [], []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) / reps * 1e3)
        queued.append((t1 - t0) / reps * 1e3)
    return _median(wall), _median(queued)


def device_ms(fn) -> float:
    """The profiler's device time of one call of ``fn``, over REPS."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / REPS / 1e3


def calls(m: dict) -> dict:
    """The named calls of the checkout ``m``."""
    out = {}
    for nx, batch in SIZES:
        cfg = m["config"].Config(nx=nx, ny=nx)
        spec = m["types"].initial_spec(cfg)
        for _ in range(2):
            spec = spec.add_pair(cfg.layer)
        params = m["types"].init_params(torch.Generator().manual_seed(0),
                                        spec, cfg.layer.rmax, device="cuda")
        opt = m["types"].init_opt_state(params)
        x = (torch.rand(batch, 3, nx, nx,
                        generator=torch.Generator().manual_seed(1)) * 255
             ).cuda()
        for domain in ("fft", "coord"):
            def forward(domain=domain, params=params, x=x, spec=spec):
                model = m["autoencoder"]
                with torch.inference_mode():
                    if domain == "fft":
                        return model.forward_fft(params, x, spec.scales)
                    return model.forward_coord(params, x, spec.scales,
                                               tap_mode="ref_gpu")[-1]

            def step(domain=domain, params=params, opt=opt, x=x, spec=spec):
                return m["modern"].train_step(params, opt, x, spec.scales,
                                              domain=domain)
            out[f"forward {domain} {nx}x{nx} b{batch}"] = forward
            out[f"step {domain} {nx}x{nx} b{batch}"] = step
    return out


def dispatch_us(m: dict) -> dict:
    """Enqueue µs per launch of K1 and K2 through their operators and
    through their CUDA kernels directly."""
    sk, ck = m["spectral_kernels"], m["coord_kernels"]
    gen = torch.Generator().manual_seed(2)
    w = 256 * 129

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=gen),
                             torch.randn(shape, generator=gen)).cuda()
    p, c = cplx(8, 3, w), cplx(10, 3, w)
    bias = torch.randn(10, generator=gen).cuda()
    x = torch.randn(4, 3, 1028, 1028, generator=gen).cuda()
    kernels = {
        "K1": (sk.cmul_contract_op, sk._cmul_contract_cuda,
               (p, c.transpose(0, 1), 0.1, False, bias, float(256 * 256))),
        "K2": (ck.conv_valid_op, ck._conv_valid_cuda,
               (x, torch.randn(10, 3, 5, 5, generator=gen).cuda()))}
    out = {}
    for name, (op, direct, args) in kernels.items():
        got = {"operator": [], "direct": []}
        for _ in range(5):
            for how in ("operator", "direct", "direct", "operator"):
                fn = op if how == "operator" else direct
                got[how].append(host_ms(lambda: fn(*args), 200, 1)[1] * 1e3)
        out[name] = {how: {"readings": v, "median": _median(v)}
                     for how, v in got.items()}
    return out


def measure(checkouts: dict, rounds: int) -> tuple[dict, dict]:
    """Readings of every call of every checkout (and ``+operators``
    variant) over ``rounds`` rounds in this process, and the dispatch
    readings."""
    variants, dispatch = {}, {}
    for name, d in checkouts.items():
        m = load(Path(d), f"ab_{name}")
        variants[name] = (calls(m), contextlib.nullcontext)
        if has_operators(m):
            variants[f"{name}+operators"] = (
                variants[name][0], lambda m=m: through_operators(m))
            dispatch[name] = dispatch_us(m)
    names = list(variants)
    got = {name: {} for name in names}
    for k in range(rounds):
        for name in (names if k % 2 == 0 else names[::-1]):
            fns, ctx = variants[name]
            with ctx():
                for call, fn in fns.items():
                    r = got[name].setdefault(call, {
                        "host_ms": [], "enqueue_ms": [], "device_ms": []})
                    for key, v in zip(("host_ms", "enqueue_ms"),
                                      host_ms(fn)):
                        r[key].append(v)
    for name in names:
        fns, ctx = variants[name]
        with ctx():
            for call, fn in fns.items():
                got[name][call]["device_ms"].append(device_ms(fn))
    return got, dispatch


def in_processes(checkouts: dict, rounds: int) -> tuple[dict, dict]:
    """:func:`measure` of one checkout and one round a process, the
    checkouts in turns."""
    got, dispatch = {name: {} for name in checkouts}, {}
    for k in range(rounds):
        for name in (list(checkouts) if k % 2 == 0
                     else list(checkouts)[::-1]):
            proc = subprocess.run(
                [sys.executable, __file__, f"{name}={checkouts[name]}",
                 "--rounds", "1", "--worker"],
                capture_output=True, text=True, check=True)
            one, disp = json.loads(proc.stdout.strip().splitlines()[-1])
            for call, r in one[name].items():
                for key, v in r.items():
                    got[name].setdefault(call, {}).setdefault(
                        key, []).extend(v)
            for key, d in disp.items():
                dispatch.setdefault(key, []).append(d)
    return got, dispatch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--processes", action="store_true",
                    help="one process a checkout and round")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    checkouts = {name: str(Path(d).resolve()) for name, d in
                 (c.split("=", 1) for c in args.checkouts)}
    if args.worker:
        got, dispatch = measure(checkouts, 1)
        # the operators variant belongs to the one-process mode
        print(json.dumps([{n: got[n] for n in checkouts}, dispatch]))
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    got, dispatch = (in_processes if args.processes else measure)(
        checkouts, args.rounds)
    names = list(got)
    first = names[0]
    result = {"checkouts": {}, "dispatch": dispatch}
    for name in names:
        result["checkouts"][name] = {}
        for call, r in got[name].items():
            med = {key: _median(v) for key, v in r.items()}
            result["checkouts"][name][call] = {
                **r, "median": med,
                f"host_vs_{first}": med["host_ms"] / _median(
                    got[first][call]["host_ms"])}
    for call in got[first]:
        print(f"{call}: " + "; ".join(
            f"{name} host {_median(got[name][call]['host_ms']):.4f} "
            f"{[round(v, 4) for v in got[name][call]['host_ms']]} enqueue "
            f"{_median(got[name][call]['enqueue_ms']):.4f} device "
            f"{_median(got[name][call]['device_ms']):.4f}"
            for name in names), flush=True)
    for name, runs in dispatch.items():
        for d in (runs if isinstance(runs, list) else [runs]):
            print(f"{name} enqueue us a launch: " + "; ".join(
                f"{kern} operator {v['operator']['median']:.2f} direct "
                f"{v['direct']['median']:.2f}" for kern, v in d.items()),
                flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "eager_ab.json").write_text(json.dumps(result))
    print(json.dumps(result))
    return 0


def _median(v: list) -> float:
    s = sorted(v)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


if __name__ == "__main__":
    sys.exit(main())
