"""Command-line interface of the port: info / export / serve.

Port of the serving subcommands of :mod:`spectralae.cli.main`, with the
same flags:

  - ``spectralae-torch info``   — print the network structure ('i' key).
  - ``spectralae-torch export`` — write a serving artifact (manifest +
    weights) from a checkpoint or a freshly initialised net.
  - ``spectralae-torch serve``  — run inference from an artifact on a
    device (``--device``, default ``cuda``), over a frame source or as an
    HTTP endpoint (``--http PORT``).

A fresh net is built as the JAX engine builds it (``initial_spec``, then
``add_pair`` once per extra layer, weights drawn uniform in ±rmax), from a
``torch.Generator`` seeded by ``--seed`` — so its weights are not the JAX
package's for the same seed.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch


def _add_common(p):
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--ny", type=int, default=None,
                   help="frame cols; defaults to --nx (square)")
    p.add_argument("--depth", type=int, default=3,
                   help="input channels (D)")
    p.add_argument("--param-file", type=str, default=None,
                   help="reference-format New_Layer_Param.txt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--layers", type=int, default=1,
                   help="number of conv stage pairs")


def _make_net(args):
    """A fresh ``(params, spec)`` on the CPU: the JAX ``_make_engine``
    construction without the interactive Engine."""
    from ..core import config as cfgmod
    from ..core.types import AEParams, init_params, init_stage, initial_spec
    if args.ny is None:
        args.ny = args.nx
    cfg = cfgmod.Config(nx=args.nx, ny=args.ny, d=args.depth)
    if args.param_file is not None:
        cfg = cfg.replace(layer=cfgmod.load_layer_params(args.param_file))
    gen = torch.Generator().manual_seed(args.seed)
    spec = initial_spec(cfg)
    params = init_params(gen, spec, cfg.layer.rmax)
    for _ in range(args.layers - 1):
        n = spec.n_pairs
        spec = spec.add_pair(cfg.layer)
        enc = init_stage(gen, spec.stages[n], cfg.layer.rmax)
        dec = init_stage(gen, spec.stages[n + 1], cfg.layer.rmax)
        params = AEParams(stages=params.stages[:n] + (enc, dec)
                          + params.stages[n:])
    return params, spec


def _info(params, spec) -> str:
    """Network-structure dump (autoencoder.cpp:458-492)."""
    lines = ["Network structure", ""]
    n = len(spec.stages)
    cx, cy = spec.nx, spec.ny
    for i, (st, sp) in enumerate(zip(params.stages, spec.stages)):
        if i < n // 2:
            lines.append(f"    L={2*i} D={st.d} Nx={cx} Ny={cy}")
            lines.append(f"P={i} S={sp.scale}")
            cx, cy = cx // sp.scale, cy // sp.scale
            lines.append(f"    L={2*i+1} D={st.d} Nx={cx} Ny={cy}")
            lines.append(f"C={i} M={st.m} D={st.d} Nk={st.nk} Nl={st.nl}")
            lines.append(f"B={i} M={st.m}")
        else:
            lines.append(f"    L={2*i} D={st.d} Nx={cx} Ny={cy}")
            lines.append(f"C={i} M={st.m} D={st.d} Nk={st.nk} Nl={st.nl}")
            lines.append(f"B={i} M={st.m}")
            cx, cy = cx * (-sp.scale), cy * (-sp.scale)
            lines.append(f"    L={2*i+1} D={st.m} Nx={cx} Ny={cy}")
            lines.append(f"P={i} S={sp.scale}")
        lines.append("-" * 10)
    lines.append(f"    L={2*n} D={spec.d} Nx={cx} Ny={cy}")
    return "\n".join(lines)


def cmd_info(args):
    params, spec = _make_net(args)
    print(_info(params, spec))


def cmd_export(args):
    """Export a serving artifact from a checkpoint (or a fresh net)."""
    from ..io import checkpoint as ckpt
    from ..io.export import export_model
    if args.platforms not in ("", "cuda"):
        raise SystemExit("--platforms: the port's artifacts hold weights, "
                         "not lowered programs; only 'cuda' is accepted "
                         "(the serving device is chosen by serve --device)")
    if args.from_ckpt:
        params, spec, _, _ = ckpt.load(args.from_ckpt)
    else:
        params, spec = _make_net(args)
    whats = (("forward", "encode") if args.what == "both"
             else (args.what,))
    for what in whats:
        # 'both' gets per-function subdirectories — each artifact owns its
        # manifest, so neither export orphans the other
        dest = (Path(args.out) / what) if len(whats) > 1 else args.out
        out = export_model(params, spec, dest, what=what,
                           domain=args.domain, batch=args.batch,
                           tap_mode=args.tap_mode)
        print(f"exported {what} ({args.domain}) -> {out}", flush=True)


def cmd_serve(args):
    """Run inference from an exported artifact over a frame source, or
    expose it over HTTP (--http PORT)."""
    from ..data import pipeline
    from ..io.export import ServingModel
    from ..viz.png import write_png
    if args.source != "synthetic":
        raise SystemExit("serve --source: only 'synthetic' is ported yet "
                         "(file and camera sources: ROADMAP A13)")
    m = ServingModel.load(args.model, device=args.device)
    if args.http is not None:
        from ..io.server import InferenceServer
        srv = InferenceServer(m, port=args.http, warmup=True,
                              batch_window_ms=args.http_batch_ms)
        print(json.dumps({"serving": args.model, "port": srv.port,
                          "device": str(m.device),
                          "routes": ["/healthz", "/infer"]}), flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            srv.shutdown()
        return
    d, nx, ny = m.input_shape
    src = pipeline.synthetic_frames(nx, ny, seed=args.seed)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    pf = pipeline.DevicePrefetcher(src, nx, ny, batch=args.batch,
                                   device=m.device)
    t0 = time.perf_counter()
    n_frames = 0
    for i, batch in enumerate(pf):
        if i >= args.steps:
            break
        out = m(batch).cpu().numpy()
        n_frames += out.shape[0]
        if args.dump_every and i % args.dump_every == 0:
            if out.shape[1] == 3:  # reconstruction -> displayable frame
                img = pipeline.tensor_to_frame(out[0])
            else:  # feature maps -> first channel, wrap-cast
                img = pipeline.feature_to_image(out[0, 0])
            write_png(outdir / f"serve_{i:05d}.png", img)
    pf.close()
    dt = time.perf_counter() - t0
    print(json.dumps({"frames": n_frames, "seconds": round(dt, 4),
                      "fps": round(n_frames / dt, 2),
                      "what": m.manifest["what"],
                      "device": str(m.device),
                      "platforms": m.manifest["platforms"]}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="spectralae-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="print network structure")
    _add_common(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("export", help="write a serving artifact")
    _add_common(p)
    p.add_argument("--from-ckpt", default="",
                   help="checkpoint dir to export from (else a fresh net)")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--what", choices=("forward", "encode", "both"),
                   default="forward")
    p.add_argument("--domain", choices=("fft", "coord"), default="fft")
    p.add_argument("--batch", type=int, default=None,
                   help="fixed batch size; omit for any batch size")
    p.add_argument("--platforms", default="",
                   help="kept for flag compatibility with the JAX CLI; "
                        "only 'cuda' is accepted")
    p.add_argument("--tap-mode",
                   choices=("ref_gpu", "ref_cpu", "centered"), default=None,
                   help="coord-domain tap window baked into the artifact "
                        "(default ref_gpu — the engine's training default; "
                        "match what the net was trained with)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("serve",
                       help="run inference from an exported artifact")
    p.add_argument("--model", required=True, help="artifact directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; no "
                        "automatic fallback to the CPU)")
    p.add_argument("--source", default="synthetic")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--outdir", default="./views")
    p.add_argument("--dump-every", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve the artifact over HTTP instead of a local "
                        "loop (GET /healthz, POST /infer with .npy body; "
                        "0 picks a free port)")
    p.add_argument("--http-batch-ms", type=float, default=0.0,
                   help="dynamic batching window for concurrent /infer "
                        "requests (any-batch artifacts only; 0 disables)")
    p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
