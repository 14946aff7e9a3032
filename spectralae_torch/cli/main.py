"""Command-line interface of the port: run / train / info / eval / export /
serve / doctor / bench.

Port of :mod:`spectralae.cli.main`, with the same flags:

  - ``spectralae-torch run``    — the reference's live loop on a frame
    source and a device (``--device``, default ``cuda``), with its 24
    keyboard commands scripted (``--keys``), read from stdin, from a
    terminal UI (``--tui``) or from OpenCV windows (``--gui``); views
    dumped as PNGs.
  - ``spectralae-torch train``  — headless training on a device
    (``--device``, default ``cuda``), with checkpoints and resume:
    ``--mode step`` (batched autodiff), ``--mode burst`` (per-batch
    100-iteration FFT bursts) and ``--mode stream`` (K frames × one fused
    burst each, or ``--domain coord``: one reference coord step each).
  - ``spectralae-torch info``   — print the network structure ('i' key).
  - ``spectralae-torch eval``   — reconstruction MSE/PSNR of a checkpoint
    or an artifact over a frame source, on a device.
  - ``spectralae-torch export`` — trace a serving artifact (manifest + a
    ``torch.export`` ``.pt2`` program) from a checkpoint or a freshly
    initialised net on a device (``--device``, default ``cuda``), loadable
    on the devices ``--platforms`` lists.
  - ``spectralae-torch serve``  — run inference from an artifact on a
    device (``--device``, default ``cuda``), over a frame source or as an
    HTTP endpoint (``--http PORT``).
  - ``spectralae-torch doctor`` — environment report: versions, the
    native library, the card, the kernel build, and (unless
    ``--no-device``) one launch of K1 held against its plain version.
  - ``spectralae-torch bench``  — the benchmark harness
    (:mod:`spectralae_torch.bench`) on a device (``--device``, default
    ``cuda``): every row of the JAX package's ``bench.py`` (``--quick``:
    its small subset; ``--xl``: the 16384² rows), details in ``--out``,
    the headline JSON line last.

``--source`` takes what the JAX CLI takes: ``synthetic``, ``camera``, a
``.y4m`` video, a ``.npy``/``.npz`` frame stack, a directory of PNGs, or
any video OpenCV can demux.  A fresh net is the interactive engine's
(``initial_spec``, then ``add_pair`` once per extra layer, weights drawn
uniform in ±rmax) from a ``torch.Generator`` seeded by ``--seed`` — so its
weights are not the JAX package's for the same seed.  No command that
takes ``--device cuda`` falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
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


def _device(args) -> torch.device:
    """The command's ``--device``; CUDA asked for and absent exits (no
    fallback to the CPU).  Library convs and matmuls beside the
    hand-written kernels run in full float32 (cuDNN would otherwise run
    TF32)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{args.cmd} --device cuda: torch finds no CUDA "
                         f"device (pass --device cpu to run on the CPU)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def _make_engine(args, device):
    from ..core.config import Config
    from ..model.engine import Engine
    if args.ny is None:
        args.ny = args.nx
    cfg = Config(nx=args.nx, ny=args.ny, d=args.depth)
    eng = Engine(cfg, seed=args.seed, param_file=args.param_file,
                 device=device)
    for _ in range(args.layers - 1):
        eng.add_layer()
    eng.select_layer(0)
    return eng


def _make_net(args):
    """A fresh ``(params, spec)`` on the CPU: the engine's net."""
    eng = _make_engine(args, "cpu")
    return eng.params, eng.spec


def _source(args):
    from ..data import pipeline
    if args.ny is None:
        args.ny = args.nx
    if args.source == "synthetic":
        return pipeline.synthetic_frames(args.nx, args.ny, seed=args.seed)
    if args.source == "camera":
        return pipeline.camera_frames()
    if args.source.endswith(".y4m"):
        return pipeline.y4m_video(args.source)
    if Path(args.source).is_dir():
        return pipeline.image_dir_frames(
            args.source, loop=True,
            channel_order=getattr(args, "png_order", "rgb"))
    if args.source.endswith((".npy", ".npz")):
        return pipeline.npy_video(args.source)
    # anything else: let OpenCV demux it (mp4/avi/mkv/...)
    return pipeline.video_file_frames(args.source, loop=True)


def _run_gui(eng, src, args):
    """Literal reference UX: four live OpenCV windows + waitKey dispatch
    (source/autoencoder.cpp:55-66 window setup, 211-246 imshow/waitKey).

    Headless-safe: exits with a clear message when no display/GUI backend
    is available (cv2.error on the first namedWindow).
    """
    from ..data import pipeline
    from ..model.engine import dispatch_key
    try:
        import cv2
    except ImportError as e:
        raise SystemExit(f"--gui requires OpenCV (cv2): {e}")
    # window name, position — the reference's exact layout
    windows = (("input", (100, 100)), ("output", (400, 100)),
               ("feature map", (100, 400)), ("kernel", (400, 400)))
    try:
        for name, (wx, wy) in windows:
            cv2.namedWindow(name, cv2.WINDOW_NORMAL)
            cv2.moveWindow(name, wx, wy)
            cv2.resizeWindow(name, 200, 200)
    except cv2.error as e:
        raise SystemExit(
            f"--gui needs a display (cv2 backend failed: {e}); use --tui "
            "or --dump-every for headless operation")
    view_to_window = {"input": "input", "output": "output",
                      "feature_map": "feature map", "kernel": "kernel"}
    try:
        for i in range(args.frames):
            frame = next(src)
            x = pipeline.frame_to_tensor(
                pipeline.resize_nn(frame, args.nx, args.ny))
            eng.step(x)
            if eng.last_mse is not None:
                print(f"frame {i}  mse: {eng.last_mse:.6g}", flush=True)
            views = eng.current_views()
            for vk, wname in view_to_window.items():
                img = views[vk]
                if img.ndim == 2:
                    img = img[:, :, None].repeat(3, axis=2)
                cv2.imshow(wname, img)
            # extra 'g'-mode views get their own windows, like the
            # reference's per-layer streams (fft_backproplib.cu:1344-1361)
            for vk, img in views.items():
                if vk not in view_to_window:
                    cv2.imshow(vk, img)
            ch = cv2.waitKey(10)
            # mask like the dispatch below — some GUI backends return the
            # keycode with modifier/high bits set (−1 = no key)
            if ch >= 0 and (ch & 0xFF) == 27:  # Esc (autoencoder.cpp:246)
                break
            if ch > 0:
                try:
                    r = dispatch_key(eng, chr(ch & 0xFF))
                    if r is not None:
                        print(f"key '{chr(ch & 0xFF)}' -> {r}", flush=True)
                except (OSError, ValueError) as e:
                    print(f"key failed: {e}", flush=True)
    finally:
        cv2.destroyAllWindows()


def cmd_run(args):
    from ..data import pipeline
    from ..model.engine import dispatch_key
    from ..viz.png import write_png
    eng = _make_engine(args, _device(args))
    src = _source(args)
    if args.gui:
        return _run_gui(eng, src, args)
    if args.tui:
        from .tui import run_tui
        return run_tui(eng, src, nx=args.nx, ny=args.ny,
                       frames=args.frames or None)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    print("commands: same keys as the reference (1..9,0,f,g,q,w,m,z,x,e,c,"
          "p,s,l,n,d,i; Esc/Q quits); enter to step", flush=True)

    def dispatch(k):
        # a failed command (e.g. 'l' with no saved weights) reports and
        # keeps the loop alive, like the reference's interactive app
        try:
            r = dispatch_key(eng, k)
            print(f"key '{k}' -> {r}", flush=True)
        except (OSError, ValueError) as e:
            print(f"key '{k}' failed: {e}", flush=True)

    for i in range(args.frames):
        frame = next(src)
        x = pipeline.frame_to_tensor(pipeline.resize_nn(frame, args.nx,
                                                        args.ny))
        t0 = time.perf_counter()
        eng.step(x)          # returns the reconstruction on the host
        dt = time.perf_counter() - t0
        if eng.last_mse is not None:
            print(f"frame {i}: {dt*1e3:.1f} ms  mse: {eng.last_mse:.6g}",
                  flush=True)
        if args.dump_every and i % args.dump_every == 0:
            for name, img in eng.current_views().items():
                write_png(outdir / f"{name}_{i:05d}.png", img)
        if args.keys and i < len(args.keys):
            dispatch(args.keys[i])
        elif args.interactive:
            line = sys.stdin.readline().strip()
            if line in ("\x1b", "Q"):
                break
            for k in line:
                dispatch(k)


def cmd_info(args):
    print(_make_engine(args, "cpu").info())


def _sync_args_to_spec(args, spec):
    """Resuming continues THAT training run: the frame pipeline must feed
    the checkpoint's resolution/depth, not the CLI defaults."""
    if (args.nx, args.ny or args.nx, args.depth) != (spec.nx, spec.ny,
                                                     spec.d):
        print(f"resume: using the checkpoint's geometry "
              f"{spec.d}x{spec.nx}x{spec.ny} (CLI asked for "
              f"{args.depth}x{args.nx}x{args.ny or args.nx})", flush=True)
    args.nx, args.ny, args.depth = spec.nx, spec.ny, spec.d


def _ckpt_dispatch(args, path, params, spec, opt, step_n, *, final=False,
                   extra_files=None):
    """The one checkpoint policy: rotating history / async mid-run / plain
    sync, with optional sidecar files (torch.optim state).

    A final save FIRST drains the async worker — writing the final
    checkpoint concurrently with a still-queued mid-run save to the same
    directory could interleave their files (a step-N manifest over
    step-M arrays)."""
    from ..io import checkpoint as ckpt
    if final:
        ckpt.wait_pending_saves()
    if args.ckpt_history > 0:
        ckpt.save_rotating(path, params, spec, opt,
                           extra={"step": step_n}, step=step_n,
                           keep=args.ckpt_history, extra_files=extra_files)
    elif extra_files is not None:
        # sidecars have no async variant: write synchronously
        ckpt.save(path, params, spec, opt, extra={"step": step_n})
        extra_files(Path(path))
    elif args.ckpt_async and not final:
        ckpt.save_async(path, params, spec, opt, extra={"step": step_n})
    else:
        ckpt.save(path, params, spec, opt, extra={"step": step_n})


def cmd_train(args):
    from ..core.profiling import device_trace
    device = _device(args)
    trace_ctx = (device_trace(args.trace) if args.trace
                 else contextlib.nullcontext())
    with trace_ctx:
        if args.mode == "step":
            return _train_steps(args, device)
        # the bursts compute their own gradients: no autograd graph
        with torch.no_grad():
            if args.mode == "burst":
                return _train_bursts(args, device)
            return _train_stream(args, device)


def _train_steps(args, device):
    from ..core.profiling import MetricsLogger
    from ..core.types import AEParams, init_opt_state
    from ..data import pipeline
    from ..io import checkpoint as ckpt
    from ..ops.coord import leaky_relu
    from ..train.modern import (make_optim_train_step, make_optimizer,
                                train_step)
    use_optim = args.optimizer != "reference"
    act = leaky_relu if args.activation == "leaky_relu" else None
    cdtype = torch.bfloat16 if args.bf16 else None
    if use_optim:
        optimizer = make_optimizer(args.optimizer, args.lr,
                                   schedule=args.lr_schedule,
                                   warmup_steps=args.warmup,
                                   total_steps=args.steps)
        optim_step = make_optim_train_step(
            optimizer, domain=args.domain, act=act, compute_dtype=cdtype,
            remat=args.remat, accum_steps=args.accum, sym=args.sym,
            maxdiff=args.maxdiff)
    start_step = 0
    if args.resume:
        params, spec, opt, extra = ckpt.load(args.resume, device=device)
        if use_optim:
            opt = optimizer.init(params)
            where = ckpt.resolve(args.resume)
            if (where / ckpt.OPTIM_SIDECAR).exists():
                opt = ckpt.load_optim_state(where / ckpt.OPTIM_SIDECAR)
            elif (where / ckpt.OPTAX_SIDECAR).exists():
                print(f"resume: {ckpt.OPTAX_SIDECAR} holds the JAX "
                      "package's optax state, which this package does not "
                      f"read; {args.optimizer} starts from a fresh state",
                      flush=True)
        elif opt is None:
            opt = init_opt_state(params)
        start_step = int(extra.get("step", 0))
        _sync_args_to_spec(args, spec)
        print(f"resumed from {args.resume} at step {start_step}", flush=True)
    else:
        params, spec = _make_net(args)
        params = AEParams.from_leaves([t.to(device)
                                       for t in params.leaves()])
        opt = (optimizer.init(params) if use_optim
               else init_opt_state(params))

    def save_ckpt(path, step_n, final=False):
        # optimizer state is written via extra_files so it lands in the
        # step dir BEFORE the LATEST marker moves — a crash between
        # the two can't expose a checkpoint with missing opt state
        sidecar = ((lambda d: ckpt.save_optim_state(
            Path(d) / ckpt.OPTIM_SIDECAR, opt)) if use_optim else None)
        _ckpt_dispatch(args, path, params, spec,
                       None if use_optim else opt, step_n, final=final,
                       extra_files=sidecar)

    src = _source(args)
    metrics = MetricsLogger(args.metrics or None)
    pf = pipeline.DevicePrefetcher(src, args.nx, args.ny, batch=args.batch,
                                   device=device)
    # the previous log line's step and the host clock after its loss read:
    # steps_per_sec is the rate since then (None on the first line)
    last_log = None
    last_step = start_step
    # last params/opt verified finite at a log step — what we roll back to
    # (and save) on divergence, so NaN updates applied between log steps
    # can never reach the final checkpoint
    good_params, good_opt, good_step = params, opt, start_step
    try:
        for step_i, batch in enumerate(pf, start=start_step):
            if step_i >= args.steps:
                break
            if use_optim:
                res = optim_step(params, opt, batch, spec.scales)
            else:
                res = train_step(params, opt, batch, spec.scales, lr=args.lr,
                                 alpha=args.alpha, domain=args.domain,
                                 compute_dtype=cdtype, act=act,
                                 remat=args.remat, accum_steps=args.accum,
                                 sym=args.sym, maxdiff=args.maxdiff)
            # failure detection (SURVEY.md §5.3): halt on divergence, keep
            # the last good checkpoint.  Reading the loss synchronises with
            # the device, so check only on log steps — off-step launches
            # stay queued behind the prefetcher
            if step_i % args.log_every == 0:
                loss = float(res.loss)
                t_read = time.perf_counter()
                if not math.isfinite(loss):
                    print(json.dumps({"step": step_i,
                                      "error": "non-finite loss",
                                      "loss": loss}), flush=True)
                    params, opt, last_step = good_params, good_opt, good_step
                    break
                # res.loss is the loss of the params going INTO this step,
                # so a finite value certifies the pre-update params
                good_params, good_opt, good_step = params, opt, last_step
            params, opt = res.params, res.opt
            last_step = step_i + 1
            if step_i % args.log_every == 0:
                rate = (None if last_log is None else
                        (step_i - last_log[0]) / (t_read - last_log[1]))
                last_log = (step_i, t_read)
                metrics.log(step=step_i, loss=loss, domain=args.domain,
                            steps_per_sec=rate)
            if (args.ckpt and args.ckpt_every > 0 and step_i
                    and step_i % args.ckpt_every == 0):
                # stamp the step REACHED (params already applied step_i's
                # update): stamping step_i made resume replay that update
                save_ckpt(args.ckpt, last_step)
    finally:
        pf.close()
        metrics.close()
    if args.ckpt:
        # stamped with the step actually REACHED (divergence break or an
        # exhausted source must not fake completion — resume would no-op)
        save_ckpt(args.ckpt, last_step, final=True)
        print(f"checkpoint written to {args.ckpt} at step {last_step}",
              flush=True)


def _resume_or_net(args, device):
    """Start params/spec/step for the burst/stream trainers: --resume
    restores them from a checkpoint (the net structure comes from the
    checkpoint, not the CLI flags); otherwise a fresh net on ``device``."""
    from ..core.types import AEParams
    from ..io import checkpoint as ckpt
    if args.resume:
        params, spec, _, extra = ckpt.load(args.resume, device=device)
        start = int(extra.get("step", 0))
        _sync_args_to_spec(args, spec)
        print(f"resumed from {args.resume} at step {start}", flush=True)
        return params, spec, start
    params, spec = _make_net(args)
    return AEParams.from_leaves([t.to(device) for t in params.leaves()]), \
        spec, 0


def _save_params_ckpt(args, params, spec, step_n, final=False):
    """Burst/stream trainer checkpointing (no optimizer state — burst
    momentum is per-pair and restarts on resume, as in the JAX package)."""
    _ckpt_dispatch(args, args.ckpt, params, spec, None, step_n,
                   final=final)
    if final:
        print(f"checkpoint written to {args.ckpt} at step {step_n}",
              flush=True)


def _selected_pairs(args, spec) -> list[int]:
    if args.train_pair == "all":
        return list(range(spec.n_pairs))
    n_l = int(args.train_pair)
    if not 0 <= n_l < spec.n_pairs:
        raise SystemExit(f"--train-pair {n_l} out of range "
                         f"(net has {spec.n_pairs} pairs)")
    return [n_l]


def _mses_host(mses: torch.Tensor) -> np.ndarray:
    """The MSE trajectories on the host (one device sync)."""
    return mses.detach().cpu().numpy().astype(np.float64)


def _train_bursts(args, device):
    """Headless reference-style training: per-batch frozen-input FFT bursts
    with batch-averaged gradients (train/fft_dp).

    The burst's internal model is the pool-free two-stage spectral conv, so
    — as in the JAX package's ``Engine._train`` and the reference
    (autoencoder.cpp:158-197) — the selected pair trains on its *pooled*
    input activation and the pre-unpool decoder output.  On the card the
    burst is the correlation-space one (``fft_burst_dp(use_pallas=None)``
    takes it for CUDA tensors) anchored on that explicit output.
    """
    from ..core.profiling import MetricsLogger
    from ..core.types import ConvStage
    from ..data import pipeline
    from ..model import autoencoder as model
    from ..train.fft_dp import fft_burst_dp
    if args.pallas_fft:
        raise SystemExit("--pallas-fft applies to --mode stream (the "
                         "fused-anchor precompute); burst mode anchors "
                         "on an explicit out0, where the signal-spectrum "
                         "routing does not exist")
    params, spec, start_step = _resume_or_net(args, device)
    pairs = _selected_pairs(args, spec)
    pf = pipeline.DevicePrefetcher(_source(args), args.nx, args.ny,
                                   batch=args.batch, device=device)
    metrics = MetricsLogger(args.metrics or None)
    # zeroed per burst (reference semantics) unless --carry-momentum
    moms = {n_l: None for n_l in pairs}
    # failure detection (SURVEY.md §5.3): params/moms last verified finite
    # at a log step — rolled back to (and saved) on divergence.  Reading
    # the mses syncs with the device, so the check rides the log cadence
    good_params, good_moms, good_step = params, dict(moms), start_step
    last_step = start_step
    diverged = False
    try:
        for step_i, batch in enumerate(pf, start=start_step):
            if step_i >= args.steps or diverged:
                break
            last_step = step_i + 1
            for n_l in pairs:
                # refresh activations between pairs — an inner pair's
                # burst changes every outer pair's target
                _, layers = model.forward_fft(params, batch, spec.scales,
                                              return_layers=True)
                in_b = layers[2 * n_l + 1]
                out_b = layers[len(layers) - 2 - 2 * n_l]
                enc, dec = params.pair(n_l)
                res = fft_burst_dp(in_b, None, out_b, enc.c, dec.c,
                                   enc.b, dec.b, moms[n_l], lr=args.lr,
                                   alpha=args.alpha, iters=args.iters,
                                   maxdiff=args.maxdiff,
                                   reanchor_every=args.reanchor or None)
                if args.carry_momentum:
                    moms[n_l] = res.mom
                params = params.replace_pair(
                    n_l, ConvStage(c=res.c, b=res.b),
                    ConvStage(c=res.f, b=res.p))
                if step_i % args.log_every == 0:
                    # the per-inner-iteration MSE trajectory, the
                    # reference's per-iter "mse" stream
                    # (fft_backproplib.cu:1463-1464), once per burst
                    mses = _mses_host(res.mses)
                    if not np.isfinite(mses).all():
                        # a non-finite entry poisons this burst's updates
                        print(json.dumps({"step": step_i, "pair": n_l,
                                          "error": "non-finite mse",
                                          "mseN": float(mses[-1])}),
                              flush=True)
                        params, moms = good_params, good_moms
                        last_step = good_step
                        diverged = True
                        break
                    metrics.log(step=step_i, pair=n_l,
                                mse0=float(mses[0]), mseN=float(mses[-1]),
                                mses=[float(v) for v in mses])
            if not diverged and step_i % args.log_every == 0:
                good_params, good_moms, good_step = (params, dict(moms),
                                                     last_step)
            if (args.ckpt and args.ckpt_every > 0 and not diverged and step_i
                    and step_i % args.ckpt_every == 0):
                _save_params_ckpt(args, params, spec, last_step)
    finally:
        pf.close()
        metrics.close()
    if args.ckpt:
        _save_params_ckpt(args, params, spec, last_step, final=True)


def _train_stream(args, device):
    """Streaming training (train/streaming.py), the frames buffered
    ``--stream-k`` at a time: K frames × one fused burst each, or with
    ``--domain coord`` one reference coordinate step each.

    Trains the selected stage pair on its pooled input activation —
    ``forward_fft``'s ``layers[2·n_l+1]``, the same activation burst mode
    trains on — with the anchor output being the pair's own two-stage
    forward (the fused re-anchoring each frame, one K4 launch per frame and
    anchor segment on the card).  Pair 0 with unit pooling scale feeds on
    the frames directly; every other case computes the activation from the
    frozen outer encoder stages per frame (``stream_bursts_pair``).
    ``--train-pair all`` round-robins the pairs one flush block at a time
    (``--pair-sweep block``) or trains every pair on every frame
    (``--pair-sweep frame``).  ``--bf16`` streams the precompute's signal
    spectra bf16 through K4.  ``--pallas-fft`` takes them from the
    four-step rfft2's kernels in mixed bin order (``"fft"``; with
    ``--bf16``, ``"fft-bf16"``: the planes stored bf16).  The coord
    domain ignores both, as the JAX CLI does.
    """
    from ..core.profiling import MetricsLogger
    from ..core.types import ConvStage
    from ..data import pipeline
    from ..train.streaming import (coord_stream, fft_stream, fft_stream_pair,
                                   fft_stream_sweep)
    params, spec, start_step = _resume_or_net(args, device)
    sweep = args.train_pair == "all"
    frame_sweep = sweep and args.pair_sweep == "frame"
    coord_domain = args.domain == "coord"
    if coord_domain:
        pw = None
    elif args.pallas_fft:
        pw = "fft-bf16" if args.bf16 else "fft"
    else:
        pw = "bf16" if args.bf16 else None
    if args.pair_sweep == "frame" and not sweep:
        raise SystemExit("--pair-sweep frame requires --train-pair all "
                         "(a single selected pair has nothing to sweep)")
    if coord_domain and frame_sweep:
        raise SystemExit("--pair-sweep frame is momentum-domain only; "
                         "coord streaming sweeps pairs per flush block "
                         "(--pair-sweep block)")
    pairs = _selected_pairs(args, spec)
    pf = pipeline.DevicePrefetcher(_source(args), args.nx, args.ny,
                                   batch=args.batch, device=device)
    metrics = MetricsLogger(args.metrics or None)
    burst_kw = dict(lr=args.lr, alpha=args.alpha, iters=args.iters,
                    maxdiff=args.maxdiff,
                    carry_momentum=args.carry_momentum,
                    reanchor_every=args.reanchor or None, pallas_windows=pw)
    # per-pair momentum (zeroed on pair switch unless carried)
    moms = {n: None for n in pairs}
    sweep_moms = None   # frame-sweep mode: per-pair tuples, pair order
    coord_state = {n: (None, None) for n in pairs}  # (mom, prev_grad)
    step_i = start_step
    block_i = 0     # sweep mode round-robins one pair per flush block
    buf = []
    # pair 0's input is the SPECTRAL pooling of the frame; feeding frames
    # directly is exact only at pooling scale 1
    pool0_direct = (not sweep and pairs[0] == 0
                    and abs(spec.scales[0]) == 1)

    def bad_frame(mses) -> int | None:
        """The first frame of a block whose MSEs are not all finite."""
        ok = np.isfinite(mses).reshape(mses.shape[0], -1).all(axis=1)
        return None if ok.all() else int(np.argmin(ok))

    def flush_coord(xs, n_l):
        """--domain coord: one reference coord step per frame
        (train/streaming.py::stream_coord_steps).

        Momentum ALWAYS carries across flush blocks (per pair): the
        reference coord loop carries dc/df continuously between frames
        (the engine's persistent _mom), and block-boundary zeroing would
        make trained weights depend on --stream-k, a pure performance
        knob.  --carry-momentum is an FFT-burst concept (the reference
        zeroes per burst); it does not apply here."""
        nonlocal params, step_i
        mo, pg = coord_state[n_l]
        r = coord_stream(xs, params, spec.scales, n_l, q=args.patch_q,
                         lr=args.lr, alpha=args.alpha, mom=mo, prev_grad=pg)
        mses = _mses_host(r.mses)                 # [K]
        bad = bad_frame(mses)
        if bad is not None:
            print(json.dumps({"step": step_i + bad, "pair": n_l,
                              "error": "non-finite mse",
                              "mse": float(mses[bad])}), flush=True)
            return False
        params = r.params
        coord_state[n_l] = (r.mom, r.prev_grad)
        for k in range(xs.shape[0]):
            if (step_i + k) % args.log_every == 0:
                metrics.log(step=step_i + k, pair=n_l, mse=float(mses[k]))
        step_i += xs.shape[0]
        return True

    def flush_frame_sweep(xs):
        nonlocal params, sweep_moms, step_i
        r = fft_stream_sweep(xs, params, spec.scales, moms=sweep_moms,
                             **burst_kw)
        mses = _mses_host(r.mses)                 # [K, n_pairs, iters+1]
        bad = bad_frame(mses)
        if bad is not None:
            print(json.dumps({"step": step_i + bad, "pair": "all",
                              "error": "non-finite mse",
                              "mseN": float(mses[bad, -1, -1])}),
                  flush=True)
            return False
        params = r.params
        if args.carry_momentum:
            sweep_moms = r.moms
        for k in range(xs.shape[0]):
            if (step_i + k) % args.log_every == 0:
                for n_l in pairs:
                    metrics.log(step=step_i + k, pair=n_l,
                                mse0=float(mses[k, n_l, 0]),
                                mseN=float(mses[k, n_l, -1]))
        step_i += xs.shape[0]
        return True

    def flush():
        nonlocal params, step_i, block_i, buf
        xs = torch.stack(buf)
        buf = []
        if frame_sweep:
            return flush_frame_sweep(xs)
        n_l = pairs[block_i % len(pairs)]
        block_i += 1
        if coord_domain:
            return flush_coord(xs, n_l)
        if pool0_direct:
            enc, dec = params.pair(0)
            r = fft_stream(xs, enc.c, dec.c, enc.b, dec.b, moms[0],
                           **burst_kw)
        else:
            r = fft_stream_pair(xs, params, spec.scales, n_l,
                                mom=moms[n_l], **burst_kw)
        mses = _mses_host(r.mses)                 # [K, iters+1]
        bad = bad_frame(mses)
        if bad is not None:
            # the per-frame MSE trajectories certify the block's updates:
            # keep the block-start weights, so the final checkpoint stays
            # finite, and halt
            print(json.dumps({"step": step_i + bad, "pair": n_l,
                              "error": "non-finite mse",
                              "mseN": float(mses[bad, -1])}), flush=True)
            return False
        params = params.replace_pair(n_l, ConvStage(c=r.c, b=r.b),
                                     ConvStage(c=r.f, b=r.p))
        if args.carry_momentum:
            moms[n_l] = r.mom
        for k in range(xs.shape[0]):
            if (step_i + k) % args.log_every == 0:
                metrics.log(step=step_i + k, pair=n_l,
                            mse0=float(mses[k, 0]),
                            mseN=float(mses[k, -1]))
        step_i += xs.shape[0]
        return True

    diverged = False
    # ckpt_every <= 0 disables mid-run saves (the final save still runs)
    next_ckpt = (start_step + args.ckpt_every if args.ckpt_every > 0
                 else float("inf"))
    try:
        for batch in pf:
            if step_i >= args.steps:
                break
            buf.append(batch)
            if len(buf) < args.stream_k and step_i + len(buf) < args.steps:
                continue
            if not flush():
                diverged = True
                break
            if args.ckpt and step_i >= next_ckpt:
                # mid-run checkpoint at block granularity
                _save_params_ckpt(args, params, spec, step_i)
                next_ckpt += args.ckpt_every * (
                    (step_i - next_ckpt) // args.ckpt_every + 1)
        if buf and not diverged:
            # a finite source ended mid-block: train on the remainder
            flush()
    finally:
        pf.close()
        metrics.close()
    if args.ckpt:
        _save_params_ckpt(args, params, spec, step_i, final=True)


def cmd_eval(args):
    """Reconstruction quality over a frame source: per-pixel MSE + PSNR.

    Evaluates either a training checkpoint (--from-ckpt, forward in the
    chosen domain) or a serving artifact (--model), on ``--device``.  The
    squared error is summed in float64 on the device; one number per
    batch comes back to the host.
    """
    from ..data import pipeline
    device = _device(args)
    if args.model:
        from ..io.export import ServingModel
        m = ServingModel.load(args.model, device=device)
        if m.manifest["what"] != "forward":
            raise SystemExit("eval needs a 'forward' artifact "
                             f"(got {m.manifest['what']!r})")
        d, nx, ny = m.input_shape
        fwd = m
    else:
        from ..io import checkpoint as ckpt
        from ..model import autoencoder as model
        if args.from_ckpt:
            params, spec, _, _ = ckpt.load(args.from_ckpt, device=device)
        else:
            eng = _make_engine(args, device)
            params, spec = eng.params, eng.spec
        nx, ny, d = spec.nx, spec.ny, spec.d
        if args.domain == "fft":
            def fwd(x):
                return model.forward_fft(params, x, spec.scales)
        else:
            def fwd(x):
                return model.forward_coord(params, x, spec.scales)[-1]
    args.nx, args.ny = nx, ny
    src = _source(args)
    pf = pipeline.DevicePrefetcher(src, nx, ny, batch=args.batch,
                                   device=device)
    sq_sum = 0.0
    n_frames = 0
    t0 = time.perf_counter()
    try:
        for i, batch in enumerate(pf):
            if i >= args.steps:
                break
            with torch.no_grad():
                out = fwd(batch)
            sq_sum += float(torch.sum((out.double() - batch.double()) ** 2))
            n_frames += batch.shape[0]
    finally:
        pf.close()
    dt = time.perf_counter() - t0
    if n_frames == 0:
        raise SystemExit("eval: source produced no frames")
    mse = sq_sum / (n_frames * d * nx * ny)
    psnr = 10.0 * np.log10(255.0 ** 2 / mse) if mse > 0 else float("inf")
    print(json.dumps({"frames": n_frames, "mse_per_pixel": round(mse, 6),
                      "psnr_db": round(psnr, 3),
                      "fps": round(n_frames / dt, 2),
                      "device": str(device)}), flush=True)


def cmd_export(args):
    """AOT-export a serving artifact (``torch.export``) from a checkpoint
    (or a fresh net), traced on ``--device``."""
    from ..core.types import AEParams
    from ..io import checkpoint as ckpt
    from ..io.export import export_model, resolve_platforms
    platforms = None
    if args.platforms:
        platforms = tuple(p.strip() for p in args.platforms.split(","))
        try:    # before the device is touched
            resolve_platforms(platforms, None)
        except ValueError as e:
            raise SystemExit(f"--platforms {args.platforms}: {e}") from None
    device = _device(args)
    if args.from_ckpt:
        params, spec, _, _ = ckpt.load(args.from_ckpt, device=device)
    else:
        params, spec = _make_net(args)
        params = AEParams.from_leaves([t.to(device)
                                       for t in params.leaves()])
    whats = (("forward", "encode") if args.what == "both"
             else (args.what,))
    for what in whats:
        # 'both' gets per-function subdirectories — each artifact owns its
        # manifest, so neither export orphans the other
        dest = (Path(args.out) / what) if len(whats) > 1 else args.out
        out = export_model(params, spec, dest, what=what,
                           domain=args.domain, batch=args.batch,
                           platforms=platforms, tap_mode=args.tap_mode)
        print(f"exported {what} ({args.domain}) -> {out}", flush=True)


def cmd_serve(args):
    """Run inference from an exported artifact over a frame source, or
    expose it over HTTP (--http PORT)."""
    from ..data import pipeline
    from ..io.export import ServingModel
    from ..viz.png import write_png
    m = ServingModel.load(args.model, device=_device(args))
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
    args.nx, args.ny = nx, ny
    src = _source(args)
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


def _probe_cuda(timeout_s: float) -> dict:
    """CUDA initialisation (the device count, the first card's name, a
    context on it) in a daemon thread with a deadline: a wedged GPU can
    hang it, and a diagnostic tool must report that, not become the second
    hung process.  The thread is a daemon so a timed-out probe cannot block
    the interpreter's exit."""
    out = {}

    def probe():
        try:
            out["cuda"] = torch.cuda.is_available()
            if out["cuda"]:
                out["device_count"] = torch.cuda.device_count()
                out["device"] = torch.cuda.get_device_name(0)
                torch.zeros(1, device="cuda")
        except Exception as e:          # report, never raise — diagnostic
            out["cuda_error"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=probe, daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        return {"cuda": False,
                "cuda_error": f"CUDA initialisation still hung after "
                              f"{timeout_s:g}s"}
    return dict(out)


def _nvidia_smi(timeout_s: float) -> list[dict] | None:
    """Each card's name and power limit as ``nvidia-smi`` reads them, or
    None where it is absent or fails."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        return None
    return [dict(zip(("name", "power_limit"),
                     (f.strip() for f in line.split(",", 1))))
            for line in r.stdout.splitlines() if line.strip()]


def _k1_check() -> dict:
    """One launch of K1 through its operator on the card, held against its
    plain version on the CPU (norm-relative, the same float32 products
    summed in another order), timed from host to host."""
    from ..ops import spectral_kernels as sk
    gen = torch.Generator().manual_seed(0)
    p, q = (torch.complex(torch.randn(shape, generator=gen),
                          torch.randn(shape, generator=gen))
            for shape in ((8, 3, 4096), (3, 10, 4096)))
    before = sk.k1_launches()
    t0 = time.perf_counter()
    # the operator itself, as a loaded .pt2 calls it (the eager wrapper
    # would skip the dispatcher)
    got = sk.cmul_contract_op(p.cuda(), q.cuda(), 1.0, False, None,
                              0.0).cpu()
    seconds = time.perf_counter() - t0
    want = sk.cmul_contract_plain(p, q)
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    launched = sk.k1_launches() - before
    return {"ok": rel <= 1e-6 and launched == 1, "rel": rel,
            "launches": launched, "round_trip_s": round(seconds, 3)}


def cmd_doctor(args):
    """Environment diagnostic: versions, the native library, the card, the
    kernel build — and (unless --no-device) one launch of K1 through its
    operator to prove the device path end to end.  CUDA initialisation is
    time-bounded, so a wedged GPU yields a report, not a hang.  Prints
    one JSON document and exits 0 whatever it finds; without a card the
    device check is left out, never run on the CPU instead."""
    from .. import _kernels
    from ..data import native
    info = {
        "torch": torch.__version__,
        "numpy": np.__version__,
        "cuda_runtime": torch.version.cuda,
        "native_lib": {
            "available": native.available(),
            "batch_stage": native.has_batch(),
            "yuv_decode": native.has_yuv(),
            "png_unfilter": native.has_png_unfilter(),
        },
    }
    try:
        import cv2
        info["opencv"] = cv2.__version__
    except ImportError:
        info["opencv"] = None
    info.update(_probe_cuda(args.device_timeout))
    info["nvidia_smi"] = _nvidia_smi(args.device_timeout)
    try:
        build = _kernels.build()
        info["kernel_build"] = {"path": str(build.path),
                                "seconds": round(build.seconds, 3)}
    except (RuntimeError, OSError) as e:
        info["kernel_build"] = {"error": f"{type(e).__name__}: "
                                         f"{str(e)[-2000:]}"}
    if not args.no_device and info.get("cuda") and "path" in info[
            "kernel_build"]:
        try:
            info["device_check"] = _k1_check()
        except (RuntimeError, ValueError) as e:
            info["device_check"] = {"ok": False,
                                    "error": f"{type(e).__name__}: {e}"}
    print(json.dumps(info, indent=2), flush=True)


def cmd_bench(args):
    from .. import bench
    bench.run(args)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="spectralae-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="interactive/streaming loop")
    _add_common(p)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; no "
                        "automatic fallback to the CPU)")
    p.add_argument("--source", default="synthetic",
                   help="synthetic | camera | a .y4m video (cv2-free) | any "
                        "OpenCV-demuxable video (mp4/avi/mkv/...) | a "
                        ".npy/.npz frame stack | a directory of .png "
                        "images (RGB by default; see --png-order)")
    p.add_argument("--png-order", choices=("rgb", "bgr"), default="rgb",
                   help="channel order of .png dataset files: 'rgb' for "
                        "standard external PNGs (reversed to the "
                        "pipeline's BGR), 'bgr' for this framework's own "
                        "viz dumps (pass-through)")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--outdir", default="./views")
    p.add_argument("--dump-every", type=int, default=0)
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--tui", action="store_true",
                   help="live ANSI terminal UI with single-key commands")
    p.add_argument("--gui", action="store_true",
                   help="the reference's four live OpenCV windows with "
                        "waitKey keyboard control (needs a display)")
    p.add_argument("--keys", default="",
                   help="scripted key sequence, one key per frame")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("info", help="print network structure")
    _add_common(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("eval",
                       help="reconstruction MSE/PSNR over a frame source")
    p.add_argument("--from-ckpt", default="",
                   help="checkpoint dir to evaluate (else a fresh net)")
    p.add_argument("--model", default="",
                   help="artifact dir to evaluate instead of a ckpt")
    p.add_argument("--domain", choices=("fft", "coord"), default="fft")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda; no "
                        "automatic fallback to the CPU)")
    p.add_argument("--source", default="synthetic")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--ny", type=int, default=None)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--param-file", type=str, default=None)
    p.add_argument("--layers", type=int, default=1)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("train", help="headless batched training")
    _add_common(p)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; no "
                        "automatic fallback to the CPU)")
    p.add_argument("--source", default="synthetic",
                   help="frame source, as for run")
    p.add_argument("--png-order", choices=("rgb", "bgr"), default="rgb")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--alpha", type=float, default=0.9)
    p.add_argument("--optimizer",
                   choices=("reference", "adam", "adamw", "sgd"),
                   default="reference",
                   help="'reference' = the normalized-gradient inertia "
                        "update; the rest are torch.optim optimizers "
                        "(their state checkpoints to optim.pt)")
    p.add_argument("--domain", choices=("fft", "coord"), default="fft",
                   help="step mode: the autodiff domain; stream mode: "
                        "'coord' streams one reference coordinate step per "
                        "frame (the '1'-with-fft-off loop) instead of FFT "
                        "bursts")
    p.add_argument("--mode", choices=("step", "burst", "stream"),
                   default="step",
                   help="step: batched autodiff training; burst: the "
                        "reference's per-batch 100-iteration FFT bursts; "
                        "stream: K frames x one fused burst each")
    # burst/stream flags; step mode ignores them (but --maxdiff, which
    # it shares)
    p.add_argument("--stream-k", type=int, default=16,
                   help="stream mode: frames per flush block")
    p.add_argument("--train-pair", default="0",
                   help="burst/stream mode: stage pair to train; 'all' "
                        "round-robins every pair — per batch in burst "
                        "mode, per flush block in stream mode; inner pairs' "
                        "activations come from the frozen outer stages")
    p.add_argument("--patch-q", type=int, default=1,
                   help="stream --domain coord: center-crop factor for "
                        "the training patch (the reference's '2'/'3' "
                        "keys, netlib.cpp Portion)")
    p.add_argument("--pair-sweep", choices=("block", "frame"),
                   default="block",
                   help="stream mode with --train-pair all: 'block' "
                        "round-robins one pair per flush block; 'frame' "
                        "trains every pair on every frame")
    p.add_argument("--iters", type=int, default=100,
                   help="burst/stream mode: inner iterations per burst (the "
                        "reference hard-codes 100, fft_backproplib.cu:1446)")
    p.add_argument("--carry-momentum", action="store_true",
                   help="burst/stream mode: carry the burst momentum across "
                        "bursts instead of zeroing it per burst (the "
                        "reference zeroes: fft_backproplib.cu:1420-1423). "
                        "Coord streaming always carries momentum, as the "
                        "reference coord loop does")
    p.add_argument("--maxdiff", action="store_true",
                   help="multiobjective kernel-diversity objective (the 'm' "
                        "key; w0=1, w1=10 as fft_backproplib.cu:1252): in "
                        "step mode on every trained stage, in burst and "
                        "stream mode inside each burst")
    p.add_argument("--sym", action="store_true",
                   help="step mode: tie each decoder stage's kernels to "
                        "its encoder's transposed (the 'p' key, "
                        "autoencoder.cpp:343-355): folded gradients, the "
                        "encoders updated, the decoders re-tied; in the fft "
                        "domain each pair's kernel spectrum computed once")
    p.add_argument("--reanchor", type=int, default=0,
                   help="burst/stream mode: re-anchor the correlation "
                        "decomposition every N inner iterations (keeps "
                        "long bursts float32-accurate; 0 = never)")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision. step mode: a bf16 forward in the "
                        "coord domain (float32 params and loss); bf16 "
                        "operands with float32 sums through the spectral "
                        "convs in the fft domain (K1's bf16 mode; the FFTs "
                        "stay float32). stream mode: the burst precompute "
                        "reads the signal spectra as bf16 planes (float32 "
                        "arithmetic). burst mode ignores it")
    p.add_argument("--pallas-fft", action="store_true",
                   help="stream mode, fft domain: compute the signal "
                        "spectra with the radix-4 four-step rfft2 "
                        "(ops/fft_kernels.py) instead of cuFFT; with "
                        "--bf16 the planes stream bf16 straight from the "
                        "FFT kernel; burst mode refuses it")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize per-stage blocks in the backward "
                        "(trades recompute for activation memory at "
                        "high resolution)")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step "
                        "(batch must divide evenly)")
    p.add_argument("--lr-schedule", choices=("constant", "cosine", "linear"),
                   default="constant",
                   help="learning-rate schedule (torch.optim optimizers "
                        "only; decays over --steps)")
    p.add_argument("--warmup", type=int, default=0,
                   help="linear lr warmup steps (torch.optim optimizers "
                        "only)")
    p.add_argument("--activation", choices=("identity", "leaky_relu"),
                   default="identity")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt", default="")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--ckpt-history", type=int, default=0, metavar="N",
                   help="keep a rotating history of the newest N "
                        "step-stamped checkpoints under --ckpt (0 = one "
                        "directory, overwritten)")
    p.add_argument("--ckpt-async", action="store_true",
                   help="write mid-run checkpoints on a background worker "
                        "(final checkpoint is always synchronous)")
    p.add_argument("--resume", default="",
                   help="checkpoint dir to resume params, optimizer state "
                        "and step from (a JAX package checkpoint too)")
    p.add_argument("--metrics", default="")
    p.add_argument("--trace", default="",
                   help="capture a torch.profiler trace of the run into "
                        "this directory (trace.json), and the train step's "
                        "spans and counters (spans.json)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("export",
                       help="AOT-export a serving artifact (torch.export)")
    _add_common(p)
    p.add_argument("--device", default="cuda",
                   help="torch device to trace on (default cuda; no "
                        "automatic fallback to the CPU)")
    p.add_argument("--from-ckpt", default="",
                   help="checkpoint dir to export from (else a fresh net)")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--what", choices=("forward", "encode", "both"),
                   default="forward")
    p.add_argument("--domain", choices=("fft", "coord"), default="fft")
    p.add_argument("--batch", type=int, default=None,
                   help="fixed batch size; omit for batch-polymorphic")
    p.add_argument("--platforms", default="",
                   help="comma-separated platforms the artifact may be "
                        "loaded on, e.g. cpu,cuda (default: the device it "
                        "is traced on)")
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

    p = sub.add_parser("doctor", help="environment diagnostic (card, "
                                      "kernel build, native lib, deps)")
    p.add_argument("--no-device", action="store_true",
                   help="skip the launch of K1 on the card")
    p.add_argument("--device-timeout", type=float, default=60.0,
                   help="seconds to wait for CUDA initialisation (and "
                        "nvidia-smi) before reporting the device path as "
                        "hung")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("bench", help="run the benchmark harness")
    from .. import bench
    bench.add_arguments(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
