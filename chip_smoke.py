#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``spectralae_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Device: require CUDA; print the card's name and power limit; turn TF32
   off for matmuls and cuDNN, so every plain version runs in float32.
2. Build: compile the hand-written kernels from ``spectralae_torch/csrc``.
3. Kernels: K1 (``cmul_contract``) and K2 (``conv_valid``) against their
   plain PyTorch versions at the stage shapes of the reference's default
   3-pair net (D=3, M=10, 5x5) at 256^2 batch 8 and at 1024^2 batch 4;
   norm-relative error, the profiler's device time and CUDA-event times,
   one line per shape; then the whole forward in both domains at both
   sizes: host time, device time and the kernels that take it.
4. Serving: ``export`` and ``serve`` through the CLI in both domains, then
   an ``InferenceServer`` over HTTP for ``forward`` and ``encode`` in both
   domains, each response held against the same model run on the CPU
   (where the plain versions run); the kernels' launch counters are reset
   before this phase and must have grown in it.

The line before the last is a JSON object with each kernel's launches in
phase 4, its largest error and its time per 256^2 batch-8 forward against
the plain version's; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import io
import itertools
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

# norm-relative tolerances, each with its reason
TOL_K1 = 1e-6      # same float32 products, summed in another order
TOL_K2 = 1e-6      # the same, over D*nk*nl taps
TOL_FFT = 1e-4     # 6 stages of float32 FFTs (cuFFT vs pocketfft) + K1
TOL_COORD = 1e-5   # 6 float32 convs (K2 / cuDNN vs the CPU's), pooling
REPS = 20          # timed launches per measurement, after 3 warm-up ones


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    wide = torch.complex128 if want.is_complex() else torch.float64
    got, want = got.to(wide), want.to(wide)
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def cuda_ms(fn) -> float:
    """Mean milliseconds of ``fn()`` over REPS launches, by CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def device_ms(fn) -> float:
    """Milliseconds the device spends in the kernels of one ``fn()``: the
    profiler's device time over REPS calls, whatever the host's pace."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / REPS / 1e3


def paired_ms(kernel, plain) -> tuple[float, float, float, float]:
    """Event times in the order plain, kernel, kernel, plain (their means),
    then the profiler's device times of kernel and plain."""
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, device_ms(kernel), device_ms(plain)


def stage_shapes(nx: int, layers: int):
    """(spatial n, D, M) of each conv stage of the default net."""
    from spectralae_torch.core.config import Config
    from spectralae_torch.core.types import initial_spec
    cfg = Config(nx=nx, ny=nx)
    spec = initial_spec(cfg)
    for _ in range(layers - 1):
        spec = spec.add_pair(cfg.layer)
    return [(s.nx, s.d, s.m) for s in spec.stages]


def phase_kernels(gen: torch.Generator) -> dict:
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import dft
    from spectralae_torch.ops import spectral_kernels as sk
    stats = {"k1": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0},
             "k2": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}}
    for nx, batch in ((256, 8), (1024, 4)):
        stages = stage_shapes(nx, 3)
        k1_rows, k2_rows = {}, {}
        for n, d, m in sorted(set(stages)):
            nyr = n // 2 + 1
            w = n * nyr
            x = torch.randn(batch, d, n, n, device="cuda", generator=gen)
            X = torch.fft.rfft2(x).reshape(batch, d, w).contiguous()
            c = (torch.rand(m, d, 5, 5, device="cuda", generator=gen)
                 * 6 - 3)
            C = dft.kernel_spectrum(c, n, n).reshape(m, d, w)
            q = C.transpose(0, 1)
            b = torch.rand(m, device="cuda", generator=gen) * 6 - 3
            kw = dict(p_scale=1.0 / m, bias=b, bias_scale=float(n * n))
            got = sk.cmul_contract(X, q, **kw)
            torch.cuda.synchronize()
            want = sk.cmul_contract_plain(X, q, **kw)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            abs_err = float((got - want).abs().max())
            ev, plain_ev, ms, plain_ms = paired_ms(
                lambda: sk.cmul_contract(X, q, **kw),
                lambda: sk.cmul_contract_plain(X, q, **kw))
            print(f"K1 cmul_contract {n}x{n} b{batch} K={d} B={m}: "
                  f"rel {err:.3e} (tol {TOL_K1:g}) max_abs {abs_err:.3e} "
                  f"device: kernel {ms:.4f} ms plain {plain_ms:.4f} ms; "
                  f"events: kernel {ev:.4f} ms plain {plain_ev:.4f} ms",
                  flush=True)
            check(err <= TOL_K1, f"K1 disagrees at {n}^2 K={d} B={m}")
            stats["k1"]["err"] = max(stats["k1"]["err"], abs_err)
            k1_rows[(n, d, m)] = (ms or ev, plain_ms or plain_ev)

            xpad = torch.randn(batch, d, n + 4, n + 4, device="cuda",
                               generator=gen)
            wt = c.flip((-2, -1)).contiguous()
            got = ck.conv_valid(xpad, wt)
            torch.cuda.synchronize()
            want = ck.conv_valid_plain(xpad, wt)
            want64 = ck.conv_valid_plain(xpad.double(), wt.double())
            torch.cuda.synchronize()
            err = rel_err(got, want)
            err64 = rel_err(got, want64)
            abs_err = float((got - want).abs().max())
            ev, plain_ev, ms, plain_ms = paired_ms(
                lambda: ck.conv_valid(xpad, wt),
                lambda: ck.conv_valid_plain(xpad, wt))
            routed = m * d <= 64
            print(f"K2 conv_valid {n}x{n} b{batch} D={d} M={m} 5x5"
                  f"{'' if routed else ' (not routed to K2 by coord.conv2d)'}"
                  f": rel {err:.3e} (tol {TOL_K2:g}; vs float64 "
                  f"{err64:.3e}) max_abs {abs_err:.3e} device: kernel "
                  f"{ms:.4f} ms plain {plain_ms:.4f} ms; events: kernel "
                  f"{ev:.4f} ms plain {plain_ev:.4f} ms", flush=True)
            check(err <= TOL_K2 and err64 <= TOL_K2,
                  f"K2 disagrees at {n}^2 D={d} M={m}")
            stats["k2"]["err"] = max(stats["k2"]["err"], abs_err)
            k2_rows[(n, d, m)] = (ms or ev, plain_ms or plain_ev, routed)
        if nx == 256:
            # time per forward: every stage's launch at that stage's shape
            for s in stages:
                ms, plain_ms = k1_rows[s]
                stats["k1"]["ms"] += ms
                stats["k1"]["plain_ms"] += plain_ms
                ms, plain_ms, routed = k2_rows[s]
                if routed:
                    stats["k2"]["ms"] += ms
                    stats["k2"]["plain_ms"] += plain_ms
    return stats


def phase_forward() -> None:
    """Host and device time of whole forwards, and where the device time
    goes (kernels by name)."""
    from torch.autograd import DeviceType
    from spectralae_torch.core.config import Config
    from spectralae_torch.core.types import init_params, initial_spec
    from spectralae_torch.model import autoencoder as model
    for nx, batch in ((256, 8), (1024, 4)):
        cfg = Config(nx=nx, ny=nx)
        spec = initial_spec(cfg)
        for _ in range(2):
            spec = spec.add_pair(cfg.layer)
        params = init_params(torch.Generator().manual_seed(0), spec,
                             cfg.layer.rmax, device="cuda")
        x = torch.rand(batch, 3, nx, nx, device="cuda") * 255
        for domain in ("fft", "coord"):
            if domain == "fft":
                def fwd():
                    return model.forward_fft(params, x, spec.scales)
            else:
                def fwd():
                    return model.forward_coord(params, x, spec.scales,
                                               tap_mode="ref_gpu")[-1]
            with torch.inference_mode():
                for _ in range(3):
                    fwd()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(REPS):
                    fwd()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / REPS * 1e3
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(REPS):
                        fwd()
                    torch.cuda.synchronize()
            rows = sorted(((e.self_device_time_total / REPS / 1e3, e.key)
                           for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA),
                          reverse=True)
            dev = sum(t for t, _ in rows)
            top = "; ".join(f"{name[:48]} {t:.4f}" for t, name in rows[:5])
            print(f"forward {domain} {nx}x{nx} b{batch}: host {wall:.4f} ms, "
                  f"device {dev:.4f} ms (busy {dev / wall:.1%}); top ms: "
                  f"{top}", flush=True)


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def phase_serving(tmp: Path) -> tuple[int, int]:
    from spectralae_torch.cli.main import main as cli
    from spectralae_torch.data import pipeline
    from spectralae_torch.io.export import ServingModel
    from spectralae_torch.io.server import InferenceServer
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import spectral_kernels as sk

    sk.LAUNCHES = 0
    ck.LAUNCHES = 0
    for domain in ("fft", "coord"):
        art = tmp / domain
        cli(["export", "--nx", "256", "--layers", "3", "--seed", "0",
             "--out", str(art), "--what", "both", "--domain", domain])
        cli(["serve", "--model", str(art / "forward"), "--steps", "3",
             "--batch", "8", "--outdir", str(tmp / "views")])
        tol = TOL_FFT if domain == "fft" else TOL_COORD
        for what in ("forward", "encode"):
            model = ServingModel.load(art / what, device="cuda")
            on_cpu = ServingModel.load(art / what, device="cpu")
            srv = InferenceServer(model, port=0)
            srv.start()
            try:
                base = f"http://127.0.0.1:{srv.port}"
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=60) as r:
                    health = json.loads(r.read())
                check(health["status"] == "ok" and health["what"] == what
                      and health["domain"] == domain, f"healthz: {health}")
                before = (sk.LAUNCHES, ck.LAUNCHES)
                worst = 0.0
                for req in range(3):
                    frames = np.stack([
                        pipeline.frame_to_tensor(f) for f in itertools.islice(
                            pipeline.synthetic_frames(256, 256,
                                                      seed=100 + req), 8)])
                    post = urllib.request.Request(
                        base + "/infer", data=_npy(frames), method="POST",
                        headers={"Content-Type":
                                 "application/octet-stream"})
                    with urllib.request.urlopen(post, timeout=120) as r:
                        got = np.load(io.BytesIO(r.read()))
                    want = on_cpu(frames)
                    check(got.shape == want.shape and got.dtype == np.float32,
                          f"{domain}/{what}: response {got.shape} "
                          f"{got.dtype}, expected {want.shape} float32")
                    check(bool(np.isfinite(got).all()),
                          f"{domain}/{what}: non-finite response")
                    err = rel_err(torch.from_numpy(got),
                                  torch.from_numpy(want))
                    worst = max(worst, err)
                    check(err <= tol, f"{domain}/{what} request {req}: "
                          f"rel {err:.3e} > {tol:g} against the CPU port")
                grew = (sk.LAUNCHES - before[0], ck.LAUNCHES - before[1])
            finally:
                srv.shutdown()
            print(f"served {domain}/{what} {tuple(got.shape)} x3 requests: "
                  f"rel vs CPU port {worst:.3e} (tol {tol:g}); launches "
                  f"during requests K1 +{grew[0]} K2 +{grew[1]}", flush=True)
            check(grew[0 if domain == "fft" else 1] > 0,
                  f"{domain}/{what}: its kernel was not launched")
    return sk.LAUNCHES, ck.LAUNCHES


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from spectralae_torch import _kernels

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    build = _kernels.build()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", build.log)]
    spills = sum(int(s) for s in
                 re.findall(r"(\d+) bytes spill stores", build.log))
    print(f"built {build.path.name} in {build.seconds:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s); ptxas: "
          f"{len(regs)} kernels, at most {max(regs, default=0)} registers, "
          f"{spills} bytes of spill stores", flush=True)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = phase_kernels(gen)
    phase_forward()

    # 4. the serving path
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        k1_launches, k2_launches = phase_serving(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(k1_launches > 0 and k2_launches > 0,
          f"serving path launched K1 {k1_launches}x, K2 {k2_launches}x")

    kernels = [
        {"name": "cmul_contract", "route": "cuda",
         "source": "spectralae_torch/csrc/cmul_contract.cu",
         "replaces": "spectralae/ops/pallas_kernels.py:48",
         "launches": k1_launches, "max_abs_err": stats["k1"]["err"],
         "ms": stats["k1"]["ms"], "plain_ms": stats["k1"]["plain_ms"]},
        {"name": "conv_valid", "route": "cuda",
         "source": "spectralae_torch/csrc/conv_valid.cu",
         "replaces": "spectralae/ops/pallas_conv.py:110",
         "launches": k2_launches, "max_abs_err": stats["k2"]["err"],
         "ms": stats["k2"]["ms"], "plain_ms": stats["k2"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
