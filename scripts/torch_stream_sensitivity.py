#!/usr/bin/env python3
"""How far a tiny change of the frames moves a stream of bursts (PyTorch port).

The stream of ``chip_smoke.py``'s card-against-CPU check: pair 0 of the
default 3-pair net (D=3, M=10, 5x5, seed 0) trained on 3 batches of 8
synthetic 256^2 frames (seed 7), one burst per batch at lr 0.2.  Each
engine runs the stream twice, on the frames and on the frames times
``1 + eps``, and prints how far the second run's weights, momentum and MSE
trajectories are from the first's.  The engines compute the same training
map by different algebra:

- ``corr``: the correlation-space burst (``stream_bursts_pair``), whose
  precompute runs K4 on the card;
- ``corr_reanchor``: the same, re-anchored every ``--reanchor`` iterations
  (each segment starts its decomposition afresh from the current error);
- ``omega``: the omega-space burst (``fft_burst_dp(use_pallas=False)``),
  anchored on the explicit two-stage forward of each frame: no
  correlation decomposition at all.

If ``omega`` moves as much as ``corr`` under the same ``eps``, the
sensitivity is the training map's, not the decomposition's.  The script
also prints how far the engines' results are from ``omega``'s.  One JSON
line per measurement::

    python scripts/torch_stream_sensitivity.py --device cpu
    python scripts/torch_stream_sensitivity.py --iters 10 100 --eps 1e-7 1e-6
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the port, from this checkout
from spectralae_torch.core.config import Config  # noqa: E402
from spectralae_torch.core.types import (AEParams, init_params,  # noqa: E402
                                         initial_spec)
from spectralae_torch.data import pipeline  # noqa: E402
from spectralae_torch.train.fft import zero_moms  # noqa: E402
from spectralae_torch.train.fft_corr import _true_forward  # noqa: E402
from spectralae_torch.train.fft_dp import fft_burst_dp  # noqa: E402
from spectralae_torch.train.streaming import (  # noqa: E402
    StreamResult, _pair_input, stream_bursts_pair)


def setup(device: str):
    cfg = Config(nx=256, ny=256)
    spec = initial_spec(cfg)
    for _ in range(2):
        spec = spec.add_pair(cfg.layer)
    params = init_params(torch.Generator().manual_seed(0), spec,
                         cfg.layer.rmax)
    params = AEParams.from_leaves([t.to(device) for t in params.leaves()])
    frames = np.stack([pipeline.frame_to_tensor(f) for f in itertools.islice(
        pipeline.synthetic_frames(256, 256, seed=7), 24)])
    xs = torch.from_numpy(frames).reshape(3, 8, 3, 256, 256).to(device)
    return params, spec.scales, xs


def omega_stream(xs, params, scales, iters: int) -> StreamResult:
    """The stream of ``stream_bursts_pair`` through the omega-space burst."""
    enc, dec = params.pair(0)
    c, f, b, p = enc.c, dec.c, enc.b, dec.b
    mom = zero_moms(c, f, b, p)
    mses = []
    for xk in xs:
        x = _pair_input(params, xk, scales, 0)
        out0 = _true_forward(x, c, f, b, p, True)
        r = fft_burst_dp(x, x, out0, c, f, b, p, mom, iters=iters,
                         use_pallas=False)
        c, f, b, p, mom = r.c, r.f, r.b, r.p, r.mom
        mses.append(r.mses)
    return StreamResult(c=c, f=f, b=b, p=p, mom=mom, mses=torch.stack(mses))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def distance(a: StreamResult, b: StreamResult) -> dict:
    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts])
    mses = ((a.mses.double().cpu() - b.mses.double().cpu()).abs()
            / b.mses.double().cpu().abs())
    return {"weights_rel": rel(flat((a.c, a.f, a.b, a.p)),
                               flat((b.c, b.f, b.b, b.p))),
            "mom_rel": rel(flat(a.mom), flat(b.mom)),
            "mses_rel_max": float(mses.max()),
            # each frame's last MSE over the other run's
            "last_mse_ratio": [float(v) for v in
                               a.mses[:, -1].double().cpu()
                               / b.mses[:, -1].double().cpu()]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, nargs="+", default=[10, 100],
                    help="inner iterations a frame, one stream each")
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7],
                    help="relative changes of the frames, one run each")
    ap.add_argument("--reanchor", type=int, default=10,
                    help="re-anchoring period of the corr_reanchor engine")
    ap.add_argument("--threads", type=int, default=4,
                    help="CPU threads (torch.set_num_threads)")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, scales, xs = setup(args.device)
    engines = {
        "corr": lambda x, it: stream_bursts_pair(x, params, scales, 0,
                                                 iters=it),
        "corr_reanchor": lambda x, it: stream_bursts_pair(
            x, params, scales, 0, iters=it, reanchor_every=args.reanchor),
        "omega": lambda x, it: omega_stream(x, params, scales, it)}
    for iters in args.iters:
        base = {}
        for name, run in engines.items():
            t0 = time.perf_counter()
            base[name] = run(xs, iters)
            for eps in args.eps:
                moved = run(xs * (1 + eps), iters)
                print(json.dumps({
                    "engine": name, "iters": iters, "eps": eps,
                    "device": args.device,
                    "moved_by_eps": distance(moved, base[name]),
                    "entry_mse": float(base[name].mses[0, 0]),
                    "last_mses": [float(v) for v in base[name].mses[:, -1]],
                    "seconds": round(time.perf_counter() - t0, 1)}),
                    flush=True)
        for name in ("corr", "corr_reanchor"):
            print(json.dumps({"engine": name, "iters": iters,
                              "device": args.device,
                              "from_omega": distance(base[name],
                                                     base["omega"])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
