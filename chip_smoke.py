#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``spectralae_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Device: require CUDA; print the card's name and power limit; turn TF32
   off for matmuls and cuDNN, so every plain version runs in float32.
2. Build: compile the hand-written kernels from ``spectralae_torch/csrc``;
   then the proof that the tensor-core kernels run on the tensor cores:
   the HGMMA (wgmma) instructions of each instantiation of
   ``dft_leaf_kernel``, ``ydft_sweep_kernel``, ``tc_sweep_kernel`` (K5,
   K6, K7) and ``tc_itergrid_kernel`` (K8) in ``cuobjdump -sass`` of the
   built library, with each one's
   registers, spills and shared memory.
3. Kernels: K1 (``cmul_contract``) and K2 (``conv_valid``) against their
   plain PyTorch versions at the stage shapes of the reference's default
   3-pair net (D=3, M=10, 5x5) at 256^2 batch 8 and at 1024^2 batch 4 —
   forward, then the backward's launches (K1's two conjugated contractions,
   K2 as the data grad) and the autograd Functions' gradients against
   autograd through the plain path; norm-relative error, the profiler's
   device time beside the plain call's, the library call's (one einsum for
   K1, cuDNN for K2) and the bound, one line per shape; K1's three
   launches with bf16 operands at the 256^2 stage shapes (no library
   call: PyTorch has no complex bf16); K1's forward, dX and dC, complex64
   and bf16, at every stage shape of the benchmark's two fft train steps
   (M = 50 at 1024^2 batch 16, M = 10 at 1024^2 batch 64), whose wide
   launches take K1's blocked design; each K1 and K2 line names the
   launch plan the wrapper took (``k1_plan``: the lane or the blocked
   design, ``k2_plan``) and each launch
   is run twice and held bit for bit; the spectral pooling's remap
   (``spectral_resize``) at each launch of a fft train step of the default
   net at both sizes and of the benchmark's two fft steps, forward and
   adjoint, bit for bit against its plain version (``resize_plain``) and
   itself, timed beside it, the gathers' autograd gradient it replaced and
   the bound, and its host microseconds a call beside the gathers'; then
   the whole forward and the
   whole train step in both domains at both sizes, in float32 and with
   bf16 operands (``compute_dtype``): host time, device time and the
   kernels that take it, with the shape of each kernel launch of one 256^2
   step recorded (a fft forward launches the resize 6 times, a fft step
   11 times).
3a. The probe kernels (``csrc/probes.cu``) through their scripts:
   ``scripts/torch_probe_mosaic_features.py`` (P1, three exact probes) and
   ``scripts/torch_probe_fused_dft.py`` (P2, ``--check`` on the card, then
   ``--n 2048``), their launches counted; then each against its plain
   version and a PyTorch call (P2: ``torch.fft.rfft`` and the weighted
   sum) with its bound; P2 at each JAX precision tier ("default",
   "high", "highest": which bf16 pieces feed the tensor cores) against its
   tier-matched plain version and within the tier's bound of the rfft
   route, with the design's tensor-core time.
   Then K3 (``corr_pair_windows``) and K4 (``anchor_windows``, float32 and
   bf16 signal) against their plain versions at the burst precompute's
   shapes: pair 0's input of the default net at 128^2 batch 8, 512^2 batch 4
   and 1024^2 batch 1 (256^2, 1024^2 and 2048^2 frames); each line names
   the launch plan (``window_plan``), each launch is run three times and
   held bit for bit, and each kernel's two grids are timed apart.
3b. The four-step rfft2 (B5, ``csrc/rfft2_mixed.cu``) at the same pair-0
   inputs, at each tier: the y-leaf, the x-leaf (float32 and bf16 out) and
   the whole transform against their tier-matched plain versions on the
   live lanes and against cuFFT within the tier's bound, timed beside the
   plain version, cuFFT, the bound (the FFT's operations or the bytes) and
   the design's tensor-core time.  The butterfly rounds and the complex
   y-leaf (B5c-e) with ``_MAX_M1`` forced to 8, then in the [3, 4096, 4096]
   transform (one round on each axis) at each tier against cuFFT, with its
   peak memory and each kernel timed (B5e at each tier).  K4 on the mixed
   planes (float32 and bf16, gathered to natural order; the gather timed
   on its own; three runs bit for bit) against its plain version and
   against K4 on cuFFT's spectra; the fused precompute's "fft" and "fft-bf16" routes (the
   transform at "high" and "default") against the default one.
3c. Bursts: host and device time of one fused burst and of one 16-frame
   stream flush at 256^2 batch 8, with the inner iterations per second,
   each beside the same call with the windows on their plain version
   (``pallas_windows=False``), the flush also on both ``--pallas-fft``
   routes; the fused precompute alone, K4 against the
   plain version, at the three sizes; and a check that the burst's entry
   points run with TF32 off whatever the caller set.
3d. The omega-space burst engines (B7-B9, ``csrc/omega_burst.cu``) at the
   JAX benchmark's headline input (one [3, 256, 256] frame), at the
   stream's pair-0 input (128^2 b8) and, for the kernels alone, at the
   headline frame with 13×13 kernels (169 taps: the contraction over taps
   in six chunks of 32): K5-K8 against their plain versions
   with float32 and bf16 operands, each output held on its own (O, the MSE
   sum, g, db, dp; K8's weights, momenta and MSEs), each run twice more
   and held bit for bit, timed with both operand types beside the plain
   version and the bound (the bytes or the float32 work plus the wgmma
   passes of the tensor-core sweep, with the float32-products bound
   beside it; no single PyTorch call computes any of them); each time says
   whether it is the profile's or the events';
   then each engine (``fft_burst_pallas``: K5 and K6 an iteration;
   ``fft_burst_pallas_fused``: one K5, then K7 an iteration;
   ``fft_burst_itergrid``: one K8 a burst) with its launches counted and no
   plain version on the card, held against the CPU port and the card's
   ``fft_burst(impl="dft")`` at 10 iterations and within the map's spread
   at 100, B9 twice bit for bit, and the host and device ms of a
   100-iteration burst beside ``fft_burst`` and ``burst_corr`` (device:
   the profiler over REPS calls, two of ``fft_burst``; the profile must
   hold every launch the counters saw).
4. Serving (ahead-of-time ``.pt2`` artifacts): ``torch.library.opcheck``
   of K1's and K2's operators on CUDA tensors at the 256^2 b8 stage-0
   shapes (K1 with complex64 and bf16 operands); ``doctor`` through the
   CLI (the card, the kernel build, its K1 check); the host and device ms
   of one ``.pt2`` forward call beside the eager forward at 256^2 b8 and
   1024^2 b4 in both domains.  Then, counters reset and the plain
   versions guarded: ``export`` (the default net at 256^2, ``--what
   both``, ``--platforms cuda,cpu``) with ``--batch 8`` and with a
   symbolic batch, and ``serve``, through the CLI in both domains; each
   artifact behind an ``InferenceServer`` over HTTP, three 8-frame
   requests, and the symbolic one called at SERVE_BATCHES: each response
   held against the same artifact loaded on the CPU (where the operators
   run their plain versions), each call launching K1, K2 and the resize
   exactly once per operator node of its graph.  A forward traced on the CPU
   (``--platforms cpu,cuda``) runs on the card, launches the kernels and
   agrees with the card-traced one (TOL_TRACE); a cpu-only artifact is
   refused on the card.  The phase's wall time is printed.
5. Training: ``train`` through the CLI on the card at 256^2 batch 8 in both
   domains, with a checkpoint and a resume; the loss must fall, the resume
   must go on from the saved weights, the launch counters must grow by
   exactly the launches of one step per step, and a 3-step run must match
   the same run on the CPU in parameters, momentum and raw gradient; then
   ``train --bf16`` in both domains, with and without ``--activation
   leaky_relu`` (K1 with bf16 operands, K2 on upcast ones), its launches
   per step counted and its loss falling, and its 3-step run against the
   CPU's.
6. Stream and burst training: ``train --mode stream`` through the CLI at
   256^2 batch 8 with a checkpoint and a resume, with ``--bf16``, and with
   ``--train-pair all --pair-sweep frame``; all of these again with
   ``--pallas-fft`` (the stream_fft path); then ``train --mode burst``, and
   ``--mode burst --pallas-fft``, which must exit with its reason.
   The MSE must fall, the resume must go on from the saved weights, K4 must
   launch exactly once per frame and pair (with ``--pallas-fft`` one y-leaf
   and one x-leaf with it; no kernel may run its plain version on the
   card), K1 and K3 exactly as the paths use them; and a 3-frame stream on
   the card must match the same stream on the CPU in weights, momentum and
   MSE trajectories at 10 iterations a frame (the default route and the
   "fft" route), and within the spread of the training map at 100.
7. The interactive loop: ``run`` through the CLI on the default net at
   256^2, one frame a step, with the key script RUN_KEYS (a fft burst, the
   'g' views, coordinate training on the innermost pair, pair switches,
   tied weights, a pair added and dropped, .conv files saved and loaded,
   the structure) and PNG dumps: K1, K2 and K3 launch exactly as the keys
   imply (``run_launches``) and no plain version runs on the card; each
   launch shape the run gave K1, K2 and K3 is held against its plain
   version on the launch's own inputs (TOL_K1, TOL_K2, TOL_WINDOWS); the
   coord mse falls; the views are written; which host codec route ran
   (numpy or the native library) is printed.  The same keys through the
   Engine API on the card and on the CPU (``fft_iters`` 10, cuDNN's TF32
   at PyTorch's default), each frame from the card's state: every
   frame's reconstruction and every activation tape the frame computes
   or its view dump recomputes (TOL_FFT, TOL_COORD), every train step
   (coord steps at TOL_COORD / TOL_MOM; the burst's weights at
   TOL_STREAM_W and its last mse, recomputed in float64 from each side's
   returned weights, at TOL_STREAM_MSE), the weights 'n' draws bit for
   bit.  The host and device ms of one ``run`` frame in each mode.
   ``train --mode stream --domain coord`` at 256^2 batch 8 with a
   checkpoint and a resume (the mse falls, K2 twice a frame), and 3
   frames of ``coord_stream`` card against CPU.  ``eval`` of phase 5's
   checkpoints and phase 4's forward artifacts, card against CPU within
   1e-5.
8. Distributed training: K4's ``row_slab`` mode (the tensor-parallel
   precompute) at pair 0's inputs of WINDOW_SIZES, float32 and bf16
   signal, the rows cut into 2 and 4 slabs and 3 slabs of which the last
   is padded: each slab's XX, EGw and seg against its plain version
   (TOL_WINDOWS), its e0 exactly 0 off row 0, three runs bit for bit, the
   slabs' sum of each output against the full call's (TOL_SLAB_SUM), each
   slab's device ms beside its plain version's, the full call's and the bound of
   its live rows.  Then this process alone on NCCL (world size 1) with the
   default net at 256^2 b8: ``distributed_burst`` (the corr body,
   ``fused=True``, ``use_pallas=True``), ``distributed_coord_step``,
   ``distributed_train_step`` and ``stream_bursts(axis_name=...)``, each
   bit for bit with its single-device call.  Then two ranks on the one
   card over gloo (``spawn_ranks``: the ``spawn`` method, a FileStore, a
   timeout on the group and on the run; the ranks load the library phase
   2 built): the DP corr burst on mesh (2, 1) (pair 0 at 128^2 b8, 4
   frames a rank) and the fused TP burst on mesh (1, 2) (1024^2 b4
   frames' pair-0 input, K4 on 256-row slabs), each against the single
   process on the card within the JAX tests' tolerances; K3 twice a DP
   precompute, K4 once a TP one on the rank's row slab; no plain version
   on the card; each distributed call's host ms.  On the same two ranks,
   the model axis on mesh (1, 2) with the default net at 256^2 b8:
   TP_STEPS ``distributed_train_step`` steps in each domain from
   ``shard_params`` (stages 0-4 on the rank's 5 output channels, the
   10 -> 3 last stage whole), gathered back and held against the single
   process's ``train_step`` (TOL_TP_STEP, TOL_MOM) and the ranks against
   each other bit for bit; ``spatial_forward`` (K1 on half of each
   stage's grid rows, the bias on rank 0's) against ``forward_fft``
   (TOL_TP_FWD); every K1 and K2 launch's shapes against the layout's
   (K2 only where the whole stage routes to it), and a step's and a
   forward's collectives against the docstring of
   ``spectralae_torch.dist.model_axis``; each step's and forward's host
   ms beside the single process's, with the card's name and power limit.
9. The benchmark harness (``spectralae_torch.bench``), short: the headline
   window's six burst impls, ``forward_fft_3layer_256_ms`` and its coord
   twin, ``modern_fft_step_b8_ms`` and ``fft_burst_dp_b8_100_ms``, and the
   5×5 conv rows with ``conv_coord_5x5_b8_ms[pallas]`` (K2), and the
   13×13 bursts (``fft_burst_100_ms_13x13[corr]`` and ``[pallas-fused]``:
   K5 and K7 on 169 taps), each two chains of two links: every row recorded with its host ms, median and
   device ms and no error, the corr row's ``pct_peak_*`` at most 105 % of
   the peaks ``device_peaks()`` names for the card, K1-K3 and K5-K8
   launched and no plain version run on the card; the rows on one line.

The line before the last is a JSON object with each kernel's launches on
every path (serve, train, train_bf16, stream, stream_fft, burst, run,
stream_coord, dist: phase 8's NCCL run and both gloo ranks, the model
axis's steps and forwards included, and
omega_pallas, omega_fused, omega_itergrid: one 100-iteration burst of each
engine at the headline input; probe_mosaic and probe_dft, the probe
scripts; bench, phase 9's rows and their costs), its largest error, and its time, plain time, bound and library
time: K1, K1 with bf16 operands, K2 and the resize per 256^2 batch-8
train step (forward and backward; the rows of phase 3 at the shapes of the
launches one such step made, summed; the resize's also by step at every
size phase 3 ran, and its host microseconds a call), K3 per precompute of a burst, K4, B5a and
B5b per launch at 256^2 batch-8 frames (at the --pallas-fft route's
"high" tier, every tier beside it; K4's row slabs beside it), B5c-e
per launch in the 4096^2 transform (B5e by tier), K5-K7 per launch and K8 per 10-iteration launch
at the headline input, P1 per launch on the probe's input, P2 per launch
at [3, 2048, 2048] (at the probe's "default" tier, every tier beside it);
beside them the engines' 100-iteration times.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import io
import itertools
import json
import math
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

from benchmark.costs import (FP32_FLOP_PER_S, HBM_BYTES_PER_S, bound_ms,
                             k1_bound, k2_bound)

# norm-relative tolerances, each with its reason
TOL_K1 = 1e-6      # same float32 products, summed in another order
TOL_K2 = 1e-6      # the same, over D*nk*nl taps
TOL_K2_DW = 1e-5   # the weight grad sums B*H*W (up to 2^20) float32 products
TOL_FFT = 1e-4     # 6 stages of float32 FFTs (cuFFT vs pocketfft) + K1
TOL_COORD = 1e-5   # 6 float32 convs (K2 / cuDNN vs the CPU's), pooling
# a CPU-traced .pt2 against a card-traced one, both on the card: one graph
# of the same operations on the same device (the same kernels, cuFFT and
# cuDNN), so only a difference of the traces could part them
TOL_TRACE = 1e-6
# the momentum after 3 steps is the last update step: clipped entries are
# +-lr(1-alpha) whatever the gradient's size, entries under GRAD_CLIP are
# g/GRAD_CLIP, so the step carries the absolute error of the small gradient
# entries, which float32 convs and FFTs summing 2^19 terms leave large
TOL_MOM = 1e-4
# K3/K4 against their plain versions: the kernels sum the window transforms
# in another order, and K4 builds the anchor spectra by its own 81-term sums
TOL_WINDOWS = 1e-5
# a 3-frame stream, card against CPU, at STREAM_CMP_ITERS iterations a
# frame, where the training map is still smooth: the float32 FFTs of two
# libraries differ by ~1e-6, and on the CPU a 1e-6 relative change of the
# frames moved the weights by 5.0e-6, the MSEs by 1.4e-5 and the momentum
# (the last update step, see TOL_MOM) by 4.1e-5
# (scripts/torch_stream_sensitivity.py)
STREAM_CMP_ITERS = 10
TOL_STREAM_W, TOL_STREAM_MOM, TOL_STREAM_MSE = 1e-4, 1e-3, 1e-4
# the same stream at STREAM_LONG_ITERS iterations a frame, held within the
# spread of the map: at lr 0.2 on pixel-scale frames a 1e-7..1e-5 relative
# change of the frames moved the weights by 8.5-12.2 % and each frame's last
# MSE by a factor 0.55-1.49 on the CPU, through the correlation-space burst,
# re-anchored or not, and through the omega-space burst alike (the map's
# own amplification, not the decomposition's precision;
# scripts/torch_stream_sensitivity.py): the card must stay within 2.5x that
# weight spread and a factor 3 of the CPU's last MSEs
STREAM_LONG_ITERS = 100
TOL_LONG_W, TOL_LONG_MSE_FACTOR = 0.3, 3.0
# (frame size, batch, channel width) of the benchmark's fft train steps
BENCH_FFT_STEPS = ((1024, 16, 50), (1024, 64, 10))
REPS = 20          # timed launches per measurement, after 3 warm-up ones
# the training phase: steps of the first run, then of the resumed one
TRAIN_STEPS, RESUME_STEPS = 20, 5
# hand-written kernel launches in one train step of the default net: K1 for
# 6 forward convs, 6 kernel-spectrum grads and 5 input-spectrum grads (the
# frames' spectra need none); K2 for the 2 routed forward convs (3->10,
# 10->3; their data grads go to F.conv2d unless PALLAS_DATA_GRAD is set)
K1_PER_FFT_STEP, K2_PER_COORD_STEP = 17, 2
# the spectral pooling's remap (``spectral_resize``) in the default net's
# fft step: 6 resizes forward, 5 adjoints back (the frames' spectra need
# none); 6 in a fft forward.  Its results copy bins: bit for bit the
# gathers' (``resize_plain``)
RS_PER_FFT_STEP, RS_PER_FFT_FORWARD = 11, 6
# the stream phase: frames of the first run and of the resumed one
STREAM_STEPS, STREAM_RESUME = 32, 16
# the interactive loop (phase 7): one key a frame after the frame (the
# reference's per-frame waitKey): fft inference, a fft burst ('1', K3), the
# tape views ('g'), the innermost pair ('x'; training an outer pair of a net
# whose inner pairs are random raises the full-net mse, as in the
# reference), coordinate mode ('f') and training ('1') over six frames,
# pair switches ('z'), tied weights ('p'), a new pair and its removal
# ('n', 'd'), the .conv files ('s', 'l'), the structure ('i'), disarm
RUN_KEYS = "1ggxf1-----zzpndsli1"
RUN_FRAMES, RUN_DUMP = 21, 2
# the batches a symbolic-batch .pt2 serves on the card (phase 4)
SERVE_BATCHES = (1, 3, 8)
RUN_COORD_FALL = (6, 11)     # coord frames of one pair whose mse must fall
ENGINE_FFT_ITERS = 10        # the engine card-vs-CPU run: pointwise bursts
# the engine's fft burst is the correlation-space one on the card and the
# omega-space one on the CPU (as in the JAX package off its accelerator).
# The correlation burst sums its running MSE from correlation terms
# anchored on mses[0], the error of the anchor the engine hands it (the
# full net's reconstruction, far above the pair's own error), so float32
# cancellation leaves its last MSE some epsilons of mses[0] off; the
# omega-space burst recomputes each MSE afresh.  So the last MSE is held as
# each side's returned weights give it (pair_mse64, float64 on the CPU), at
# TOL_STREAM_MSE; each burst's own last MSE against that is printed
# the coord stream phase: frames (batches of 8) of the first run and the
# resumed one, and the frames held card against CPU
COORD_STREAM_STEPS, COORD_STREAM_RESUME, COORD_CMP_FRAMES = 24, 8, 3
# burst precompute shapes: (frame size, batch) -> pair 0's input at half
WINDOW_SIZES = ((256, 8), (1024, 4), (2048, 1))
# the four-step rfft2 (B5) against its plain versions: the same float32
# products summed in another order (at most 2·512 terms a bin)
TOL_B5 = 1e-5
# bf16 planes against the plain float32 ones: the 2^-9 storage rounding
TOL_B5_BF16 = 6e-3
# the JAX dot tiers the matmul-DFT kernels (the B5 leaves, P2) run at on
# the card (csrc/wgmma.cuh): each kernel is held against its tier-matched
# plain version within TOL_B5 (the same bf16 pieces, exact float32
# products; for the whole transform the plain x-stage takes the kernels'
# own y-stage), and against the exact transform within the tier's bound
# from fft_kernels (TIER_TOL; P2: p2_tier_tol), which also holds the tiers
# (TIERS) and a design's tensor-core time (design_tc_ms)
# the transform's tier on each --pallas-fft route (train/fft_corr.py)
ROUTE_TIER = {"fft": "high", "fft-bf16": "default"}
# K4 and the fused precompute on the four-step spectra against the cuFFT
# ones: the two transforms' float32 rounding (~1e-6) through the windows;
# the bf16 planes: the band of tests/test_torch_windows.py
TOL_FFT_ROUTE, TOL_FFT_ROUTE_BF16 = 1e-4, 2e-2
# the pallas-fft stream phase: frames of the first run and of the resumed
STREAM_FFT_STEPS, STREAM_FFT_RESUME = 16, 8
# the recursion on the card: pair 0's input of 8192^2 frames, batch 1
RECURSION_N = 4096
# K1 with bf16 operands against its plain version on the same bf16 planes:
# a product of two bf16 values is exact in float32, so only the order of
# the float32 sums differs
TOL_K1_BF16 = 1e-5
# 3 bf16 train steps, card against CPU (parameters, momentum, raw
# gradient): a float32 FFT or conv result that differs by ~1e-7 between
# the libraries rounds to another bf16 value now and then.  On the CPU a
# 1e-7 or 1e-6 relative change of the frames moved a 3-step bf16 run by at
# most 4.1e-9 / 3.7e-8 / 3.7e-7 (fft) and 3.8e-5 / 9.1e-4 / 3.9e-4 (coord:
# every activation is stored in bf16); the bounds are ten times those,
# and the float32 fft bounds where those are larger
TOL_BF16 = {"fft": (TOL_FFT, TOL_MOM, TOL_FFT),
            "coord": (4e-4, 1e-2, 4e-3)}
# those bounds hold the card against the CPU taking the card's routes (every
# spectral conv through SpectralConvFused, the coord convs of K2's shapes
# through ConvValid, their plain versions on the CPU).  The CLI on the CPU
# takes the einsum and F.conv2d, as the JAX package does off its
# accelerator: in bf16 those round the gradients at other points than the
# kernels' VJPs (JAX's einsum and its fused conv differ the same way; on the
# CPU the two routes' 3-step runs differed by 2.2e-3 / 6.8e-2 / 1.2e-2 in
# the fft domain), two formulations of one bf16 step, so only the card's
# routes are a like-for-like reference
# the probe kernels (P1: exact; P2: the y-DFT energy of [3, n, n] frames
# against its plain version's float32 products and against torch.fft.rfft)
P1_ROWS = (  # counter key, kernel, the Pallas function it replaces
    ("p1a", "lane_strided", "scripts/probe_mosaic_features.py:46"),
    ("p1b", "sublane_strided", "scripts/probe_mosaic_features.py:65"),
    ("p1c", "middle_store", "scripts/probe_mosaic_features.py:84"))
# the elements of its input each P1 function reads
P1_READS = {"lane_strided": lambda x: x[:, 1::4],
            "sublane_strided": lambda x: x[1::4, :],
            "middle_store": lambda x: x}
P2_N, TOL_P2 = 2048, 1e-5


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from spectralae_torch import _kernels
    _kernels.LAUNCHES.clear()


def counts() -> dict:
    """Every kernel's launch count, by kernel key."""
    from spectralae_torch._kernels import LAUNCHES as n
    from spectralae_torch.ops import spectral_kernels as sk
    return {"k1": sk.k1_launches(), "k1bf": sk.k1_launches(True),
            "k2": n["conv_valid"], "rs": n["spectral_resize"],
            "k3": n["corr_pair_windows"], "k4": n["anchor_windows"],
            "b5a": n["rfft_y_mixed"], "b5b": n["fft_x_mixed"],
            "b5c": n["bfly_lanes"], "b5d": n["bfly_rows"],
            "b5e": n["fft_yc"],
            **{key: n[name] for key, name, _ in OMEGA_ROWS + P1_ROWS},
            "p2": n["ydft_energy"]}


def grown(before: dict) -> dict:
    now = counts()
    return {k: now[k] - before[k] for k in now}


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


# device operation records the profiles held and should have held: late in
# this run the profiler drops records (it once held 19 of 20 K8 launches,
# and fewer than half of one K5 row's)
PROFILED = {"held": 0, "expected": 0}


def device_ops(fn, calls: int = REPS) -> list[tuple[str, float, int, int]]:
    """Each device operation (kernel, copy) of one ``fn()`` as (name, mean
    ms, instances a call, records held), from the profiler over ``calls``
    calls after one untimed call.  The instances a call are the records
    over ``calls``, rounded and at least 1, so dropped records move the
    time a call (the mean times the instances) only where they change the
    rounding; PROFILED keeps the tally."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.count:
            continue
        k = max(1, math.floor(e.count / calls + 0.5))
        PROFILED["held"] += min(e.count, k * calls)
        PROFILED["expected"] += k * calls
        out.append((e.key, e.self_device_time_total / e.count / 1e3, k,
                    e.count))
    return out


def device_ms(fn, names=None) -> float:
    """Milliseconds the device spends in the kernels of one ``fn()``: the
    profiler's device time over REPS calls, whatever the host's pace.
    ``names``: count only the kernels whose name holds one of them."""
    return sum(ms * k for key, ms, k, _ in device_ops(fn)
               if names is None or any(n in key for n in names))


def paired_ms(kernel, plain) -> tuple[float, float, float, float]:
    """Event times in the order plain, kernel, kernel, plain (their means),
    then the profiler's device times of kernel and plain."""
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, device_ms(kernel), device_ms(plain)


def _checked_ms(ms: float, fn, ev: float) -> tuple[float, str]:
    """A profiled device time of one ``fn()`` and where it came from,
    retaken once when the profile held no record of the call (the profiler
    drops records, see PROFILED) or read more than the call's event time
    (it also repeats records: one P2 profile read 4.62 ms a call against
    2.00 ms of events, and a call's device work cannot outlast its span on
    the stream, 5 % allowed for the two windows' noise).  The events stand
    in if the second profile fails too; they hold the host's launch gaps,
    so the source reads "events" and not "profile"."""
    for retake in (False, True):
        if retake:
            ms = device_ms(fn)
        if 0 < ms <= 1.05 * ev:
            return ms, "profile"
    return ev, "events"


def _sources(rows) -> str:
    """Where the ``ms`` of summed rows came from: "profile", "events", or
    both joined by "+"."""
    return "+".join(sorted({r["ms_source"] for r in rows}))


def measure(label: str, got, want, kernel, plain, bound, tol: float, *,
            library=True, extra: str = "", names=None, share: float = 0.0,
            rel=None) -> dict:
    """Hold ``got`` against ``want``, time ``kernel`` against ``plain``,
    print one line, return the row.  ``library`` is the one PyTorch call
    that computes the same function: ``plain`` itself when True, None when
    there is none, its time when measured already (a float), else a call
    timed on its own.  ``names``: the kernel's
    time is that of its own grids (the wrapper's other device work, such
    as a cast, is printed as the call's time), retaken once when the
    profile held none of their records, read more than the call or less
    than ``share`` of it (where the grids are nearly all of the call's
    device work: a profile that dropped records), and else the call's
    time.  ``rel``: the error to hold
    and report in place of ``got``'s against ``want`` (the largest of
    outputs the caller held one by one)."""
    err = rel_err(got, want) if rel is None else rel
    abs_err = float((got - want).abs().max())
    ev, plain_ev, ms, plain_ms = paired_ms(kernel, plain)
    ms, src = _checked_ms(ms, kernel, ev)
    plain_ms, plain_src = _checked_ms(plain_ms, plain, plain_ev)
    if names is not None:
        extra += f"; the call {ms:.4f} ms ({src})"
        for _ in range(2):     # the profiler drops records (PROFILED)
            own = device_ms(kernel, names)
            if 0 < own and share * ms <= own <= 1.05 * ms:
                ms, src = own, "profile"
                break
            extra += f"; its grids read {own:.4f} ms, not taken"
    if library is True:
        lib_ms, lib_txt = plain_ms, " (the library call)"
    elif library is None:
        lib_ms, lib_txt = None, " library none"
    elif isinstance(library, float):
        lib_ms, lib_txt = library, f" library {library:.4f} ms (timed once)"
    else:
        lib_ms, lib_src = _checked_ms(device_ms(library), library,
                                      cuda_ms(library))
        lib_txt = f" library {lib_ms:.4f} ms ({lib_src})"
    print(f"{label}: rel {err:.3e} (tol {tol:g}{extra}) max_abs "
          f"{abs_err:.3e} device: kernel {ms:.4f} ms ({src}) plain "
          f"{plain_ms:.4f} ms ({plain_src}){lib_txt} bound {bound[0]:.4f} "
          f"ms ({bound[1]}); events: kernel {ev:.4f} ms plain "
          f"{plain_ev:.4f} ms", flush=True)
    check(err <= tol, f"{label} disagrees: rel {err:.3e} > {tol:g}")
    return {"abs": abs_err, "rel": err, "ms": ms, "ms_source": src,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib_ms}


def k1_key(p, q, conj_q: bool = False, bias=None) -> tuple:
    """What sets the work of one K1 launch: the operands' shapes, the
    conjugation and the bias."""
    return tuple(p.shape), tuple(q.shape), bool(conj_q), bias is not None


def k2_key(xpad, w) -> tuple:
    return tuple(xpad.shape), tuple(w.shape)


@contextlib.contextmanager
def guard_plains(plains, fallbacks: list):
    """Inside the block, record every call of the plain versions
    ``plains`` ((module, name) pairs) on a CUDA tensor in ``fallbacks``:
    on the card each must launch its kernel."""
    real = {(mod, name): getattr(mod, name) for mod, name in plains}

    def guarded(name, fn):
        def guard(x, *a, **kw):
            t = x[0] if isinstance(x, (tuple, list)) else x
            if t.is_cuda:
                fallbacks.append((name, tuple(t.shape)))
            return fn(x, *a, **kw)
        return guard
    for (mod, name), fn in real.items():
        setattr(mod, name, guarded(name, fn))
    try:
        yield
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def rs_key(x, nx, ny, nxs, nys, adjoint) -> tuple:
    """What sets the work of one resize launch: the input's shape, the
    sizes and the direction."""
    return tuple(x.shape), (nx, ny, nxs, nys), bool(adjoint)


@contextlib.contextmanager
def launch_log():
    """Record the key of every kernel launch made inside the block, by
    kernel, calling through to the wrappers (which count the launches)."""
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import resize_kernels as rk
    from spectralae_torch.ops import spectral_kernels as sk
    log = {"k1": [], "k2": [], "rs": []}
    k1, k2, rs = sk.cmul_contract, ck._valid_corr, rk.spectral_resize

    def k1_spy(p, q, **kw):
        log["k1"].append(k1_key(p, q, kw.get("conj_q", False),
                                kw.get("bias")))
        return k1(p, q, **kw)

    def k2_spy(xpad, w):
        log["k2"].append(k2_key(xpad, w))
        return k2(xpad, w)

    def rs_spy(x, nx, ny, nxs, nys, adjoint=False):
        log["rs"].append(rs_key(x, nx, ny, nxs, nys, adjoint))
        return rs(x, nx, ny, nxs, nys, adjoint)
    sk.cmul_contract, ck._valid_corr = k1_spy, k2_spy
    rk.spectral_resize = rs_spy
    try:
        yield log
    finally:
        sk.cmul_contract, ck._valid_corr = k1, k2
        rk.spectral_resize = rs


@contextlib.contextmanager
def kernel_inputs():
    """Inside the block, keep the inputs and the result of the first
    launch of K1, K2 and K3 at each launch shape, calling through to the
    wrappers (which count the launches); :func:`hold_kernel_inputs` holds
    them against the plain versions."""
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import spectral_kernels as sk
    from spectralae_torch.train import fft_corr
    kept = {}
    k1, k2, k3 = sk.cmul_contract, ck._valid_corr, fft_corr.corr_pair_windows

    def keep(key, args, kw, out):
        if key not in kept:
            kept[key] = ([a.clone() if torch.is_tensor(a) else a
                          for a in args],
                         {k: v.clone() if torch.is_tensor(v) else v
                          for k, v in kw.items()}, out.clone())

    def k1_spy(p, q, **kw):
        out = k1(p, q, **kw)
        keep(("k1",) + k1_key(p, q, kw.get("conj_q", False), kw.get("bias")),
             (p, q), kw, out)
        return out

    def k2_spy(xpad, w):
        out = k2(xpad, w)
        keep(("k2",) + k2_key(xpad, w), (xpad, w), {}, out)
        return out

    def k3_spy(X, Z, *dims):
        out = k3(X, Z, *dims)
        keep(("k3", tuple(X.shape), tuple(Z.shape), X is Z) + dims,
             (X, Z) + dims, {}, out)
        return out
    sk.cmul_contract, ck._valid_corr = k1_spy, k2_spy
    fft_corr.corr_pair_windows = k3_spy
    try:
        yield kept
    finally:
        sk.cmul_contract, ck._valid_corr = k1, k2
        fft_corr.corr_pair_windows = k3


def hold_kernel_inputs(label: str, kept: dict) -> None:
    """Each kept launch (:func:`kernel_inputs`) against its plain version
    on the same inputs: K1 at TOL_K1, K2 at TOL_K2, K3 at TOL_WINDOWS."""
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import spectral_kernels as sk
    from spectralae_torch.ops import window_kernels as wk
    plains = {"k1": (sk.cmul_contract_plain, TOL_K1),
              "k2": (ck.conv_valid_plain, TOL_K2),
              "k3": (wk.corr_pair_windows_plain, TOL_WINDOWS)}
    worst = {}
    for key, (args, kw, out) in kept.items():
        plain, tol = plains[key[0]]
        err = rel_err(out, plain(*args, **kw))
        check(err <= tol, f"{label}: {key[0].upper()} at {key[1:]} "
              f"disagrees with its plain version: {err:.3e} > {tol:g}")
        n, e = worst.get(key[0], (0, 0.0))
        worst[key[0]] = (n + 1, max(e, err))
    check(set(worst) == set(plains), f"{label}: no launch of "
          f"{sorted(set(plains) - set(worst))} was kept")
    print(f"{label}: each launch shape against its plain version on the "
          "launch's own inputs: " + ", ".join(
              f"{k.upper()} {n} shapes, worst {e:.3e} (tol "
              f"{plains[k][1]:g})" for k, (n, e) in sorted(worst.items())),
          flush=True)


def pair_mse64(x, c, f, b, p) -> float:
    """The stage pair's reconstruction MSE of ``x`` (the fft burst's own
    measure: the pool-free two-stage spectral conv, Parseval-normalized),
    recomputed in float64 on the CPU."""
    from spectralae_torch.ops import spectral
    x, c, f, b, p = (t.detach().cpu().double() for t in (x, c, f, b, p))
    nx, ny = x.shape[-2:]
    X = spectral.rfft2(x)
    H = spectral.spectral_conv_einsum(
        X[None], spectral.rfft2(spectral.kernel_pad(c, nx, ny)), b, nx, ny)
    O = spectral.spectral_conv_einsum(
        H, spectral.rfft2(spectral.kernel_pad(f, nx, ny)), p, nx, ny)[0]
    return float(spectral.parseval_mse(X, O, c.shape[1], c.shape[0], nx, ny))


def stage_shapes(nx: int, layers: int, depth: int = 10):
    """(spatial n, D, M) of each conv stage of the default net, or of the
    net whose stages are ``depth`` channels wide."""
    from spectralae_torch.core.config import Config, LayerParams
    from spectralae_torch.core.types import initial_spec
    cfg = Config(nx=nx, ny=nx, layer=LayerParams(depth=depth))
    spec = initial_spec(cfg)
    for _ in range(layers - 1):
        spec = spec.add_pair(cfg.layer)
    return [(s.nx, s.d, s.m) for s in spec.stages]


def _grads_line(label: str, pairs, tol: float) -> float:
    """Print and check named (got, want, tol) gradient comparisons."""
    errs = [(name, rel_err(g, w), t or tol) for name, g, w, t in pairs]
    print(f"{label}: " + ", ".join(f"{n} rel {e:.3e} (tol {t:g})"
                                   for n, e, t in errs), flush=True)
    for name, e, t in errs:
        check(e <= t, f"{label}: {name} rel {e:.3e} > {t:g}")
    return max(float((g - w).abs().max()) for _, g, w, t in pairs
               if t is None)


def k1_plan_text(p, q, vec: int, op_bytes: int) -> str:
    """The design and launch plan K1's wrapper takes for these operands
    (rows whose 16-byte vectors are aligned, as at every stage shape
    here; ``op_bytes``: 8 for complex64, 4 for bf16 pairs)."""
    from spectralae_torch.ops import spectral_kernels as sk
    a, k, w = p.shape[:3]
    plan = sk.k1_plan(a, k, q.shape[1], w, vec, op_bytes)
    if isinstance(plan, sk.K1BlockedPlan):
        return (f"; design blocked, {plan.na}x{plan.nb} warps a block "
                f"({plan.na * sk._K1B_RA} rows x {plan.nb * sk._K1B_RB} "
                f"channels), kc {plan.kc}, {plan.stages} stages "
                f"({plan.smem} B shared), grid {plan.grid} over tiles "
                f"{plan.tiles}")
    return (f"; design lane, {plan.group} channel warps a block, "
            f"{plan.rows} rows a thread, grid {plan.grid}")


def k1_repeated(p, q, kw) -> torch.Tensor:
    """One K1 launch, run again and held bit for bit (every output is one
    thread's fixed-order sum)."""
    from spectralae_torch.ops import spectral_kernels as sk
    got = sk.cmul_contract(p, q, **kw)
    check(torch.equal(got, sk.cmul_contract(p, q, **kw)),
          f"K1 at {tuple(p.shape)} x {tuple(q.shape)} does not repeat")
    return got


def k2_repeated(xpad, w) -> tuple[torch.Tensor, str]:
    """One K2 launch, run again and held bit for bit, and its plan."""
    from spectralae_torch.ops import coord_kernels as ck
    got = ck.conv_valid(xpad, w)
    check(torch.equal(got, ck.conv_valid(xpad, w)),
          f"K2 at {tuple(xpad.shape)} x {tuple(w.shape)} does not repeat")
    b, d, hp, wp = xpad.shape
    plan = ck.k2_plan(b, d, w.shape[0], hp, wp, *w.shape[2:])
    return got, (f"; plan {plan.tx}x{plan.ty} threads, {plan.mb} channels "
                 f"a thread, grid {plan.grid}")


def k1_shape(gen, n: int, batch: int, d: int, m: int,
             bf16: bool = False) -> tuple[dict, float]:
    """K1 at one stage shape: the forward, the backward's dX and dC
    contractions, and SpectralConvFused's gradients against autograd
    through the plain einsum.  Returns the timed rows by launch key (each
    with its part of the step, forward or backward) and the largest
    absolute error.  The library call is one ``torch.einsum`` of the same
    operands, conjugated for dX and dC, without the 1/M scale and the DC
    bias (two passes of their own).  ``bf16``: the three launches with the
    bf16 operands SpectralConvFused makes (X/M rounded after the scale, g
    rounded before it), against the plain version on the same planes; no
    library call (PyTorch has no complex bf16)."""
    from spectralae_torch.ops import dft, spectral
    from spectralae_torch.ops import spectral_kernels as sk
    nyr = n // 2 + 1
    w = n * nyr
    tag = f"{n}x{n} b{batch}"
    x = torch.randn(batch, d, n, n, device="cuda", generator=gen)
    X = torch.fft.rfft2(x).reshape(batch, d, w).contiguous()
    c = torch.rand(m, d, 5, 5, device="cuda", generator=gen) * 6 - 3
    C = dft.kernel_spectrum(c, n, n).reshape(m, d, w)
    b = torch.rand(m, device="cuda", generator=gen) * 6 - 3
    g = torch.randn(batch, m, w, dtype=torch.complex64, device="cuda",
                    generator=gen)
    rows = {}
    if bf16:
        xs, gp = sk.bf16_planes(X, 1.0 / m), sk.bf16_planes(g)
        cases = (
            ("fwd", f"forward {tag} K={d} B={m} bf16", xs,
             sk.bf16_planes(C).transpose(0, 1),
             dict(bias=b, bias_scale=float(n * n)),
             k1_bound(batch, d, m, w, bias=True, op_bytes=4)),
            ("bwd", f"dX {tag} K={m} B={d} bf16 (p=g, q=conj C)", gp,
             sk.bf16_planes(C), dict(p_scale=1.0 / m, conj_q=True),
             k1_bound(batch, m, d, w, op_bytes=4)),
            ("bwd", f"dC {tag} K={batch} B={d} bf16 (p=g^T view, q=conj "
             "X/M)", gp.transpose(0, 1), xs, dict(conj_q=True),
             k1_bound(m, batch, d, w, op_bytes=4)))
        for part, label, p, q, kw, bound in cases:
            row = measure(
                f"K1 cmul_contract {label}",
                k1_repeated(p, q, kw), sk.cmul_contract_plain(p, q, **kw),
                lambda: sk.cmul_contract(p, q, **kw),
                lambda: sk.cmul_contract_plain(p, q, **kw), bound,
                TOL_K1_BF16, library=None, extra=k1_plan_text(p, q, 4, 4))
            rows[k1_key(p, q, kw.get("conj_q"), kw.get("bias"))] = dict(
                row, part=part)
        return rows, max(r["abs"] for r in rows.values())
    gt = g.transpose(0, 1)
    fwd = dict(p_scale=1.0 / m, bias=b, bias_scale=float(n * n))
    bwd = dict(p_scale=1.0 / m, conj_q=True)
    for part, label, p, q, kw, bound in (
            ("fwd", f"forward {tag} K={d} B={m}", X, C.transpose(0, 1), fwd,
             k1_bound(batch, d, m, w, bias=True)),
            ("bwd", f"dX {tag} K={m} B={d} (p=g, q=conj C)", g, C, bwd,
             k1_bound(batch, m, d, w)),
            ("bwd", f"dC {tag} K={batch} B={d} (p=g^T view, q=conj X)", gt,
             X, bwd, k1_bound(m, batch, d, w))):
        q_lib = q.conj() if kw.get("conj_q") else q
        row = measure(
            f"K1 cmul_contract {label}",
            k1_repeated(p, q, kw), sk.cmul_contract_plain(p, q, **kw),
            lambda: sk.cmul_contract(p, q, **kw),
            lambda: sk.cmul_contract_plain(p, q, **kw), bound, TOL_K1,
            library=lambda: torch.einsum("akw,kbw->abw", p, q_lib),
            extra=k1_plan_text(p, q, 2, 8))
        rows[k1_key(p, q, kw.get("conj_q"), kw.get("bias"))] = dict(
            row, part=part)
    grads = []
    for conv in (sk.spectral_conv_fused, spectral.spectral_conv_einsum):
        leaves = [X.reshape(batch, d, n, nyr).clone().requires_grad_(),
                  C.reshape(m, d, n, nyr).clone().requires_grad_(),
                  b.clone().requires_grad_()]
        y = conv(*leaves, n, n)
        grads.append(torch.autograd.grad(y, leaves,
                                         g.reshape(batch, m, n, nyr)))
    abs_err = _grads_line(
        f"SpectralConvFused grads {tag} D={d} M={m} vs autograd through "
        "spectral_conv_einsum",
        [(name, got, want, None)
         for name, got, want in zip(("dX", "dC", "db"), *grads)], TOL_K1)
    return rows, max(abs_err, *(r["abs"] for r in rows.values()))


def k2_shape(gen, n: int, batch: int, d: int, m: int) -> tuple[dict, float]:
    """K2 at one stage shape: the forward, the data grad through K2 (the
    PALLAS_DATA_GRAD route) against F.conv2d's, and ConvValid's gradients
    against autograd through F.conv2d in float32 and float64.  Returns the
    timed rows by launch key and the largest absolute error."""
    import torch.nn.functional as F
    from spectralae_torch.ops import coord_kernels as ck
    tag = f"{n}x{n} b{batch}"
    routed = m * d <= 64
    note = "" if routed else " (not routed to K2 by coord.conv2d)"
    xpad = torch.randn(batch, d, n + 4, n + 4, device="cuda", generator=gen)
    c = torch.rand(m, d, 5, 5, device="cuda", generator=gen) * 6 - 3
    wt = c.flip((-2, -1)).contiguous()
    dy = torch.randn(batch, m, n, n, device="cuda", generator=gen)
    rows = {}
    got, plan = k2_repeated(xpad, wt)
    err64 = rel_err(got, ck.conv_valid_plain(xpad.double(), wt.double()))
    check(err64 <= TOL_K2, f"K2 {tag} disagrees with float64: {err64:.3e}")
    rows[k2_key(xpad, wt)] = dict(measure(
        f"K2 conv_valid forward {tag} D={d} M={m} 5x5{note}", got,
        ck.conv_valid_plain(xpad, wt), lambda: ck.conv_valid(xpad, wt),
        lambda: ck.conv_valid_plain(xpad, wt),
        k2_bound(batch, d, m, n + 4, n + 4, 5, 5), TOL_K2,
        extra=f"; vs float64 {err64:.3e}{plan}"), part="fwd")
    # the data grad: dy padded by the taps, weights M/D-transposed and
    # flipped — a valid correlation with M input and D output channels
    dy_pad = F.pad(dy, (4, 4, 4, 4))
    wtt = wt.transpose(0, 1).flip((-2, -1)).contiguous()
    got, plan = k2_repeated(dy_pad, wtt)
    err64 = rel_err(got, F.conv2d(dy_pad.double(), wtt.double()))
    check(err64 <= TOL_K2, f"K2 dx {tag} disagrees with float64: {err64:.3e}")
    rows[k2_key(dy_pad, wtt)] = dict(measure(
        f"K2 conv_valid data grad {tag} {m}->{d} at {n + 8}^2 "
        f"(PALLAS_DATA_GRAD route) vs F.conv2d", got,
        F.conv2d(dy_pad, wtt), lambda: ck.conv_valid(dy_pad, wtt),
        lambda: F.conv2d(dy_pad, wtt),
        k2_bound(batch, m, d, n + 8, n + 8, 5, 5), TOL_K2,
        extra=f"; vs float64 {err64:.3e}{plan}"), part="bwd")
    grads = {}
    for name, fn, dtype in (("fn", ck.conv_valid, torch.float32),
                            ("f32", F.conv2d, torch.float32),
                            ("f64", F.conv2d, torch.float64)):
        leaves = [xpad.to(dtype).requires_grad_(),
                  wt.to(dtype).requires_grad_()]
        grads[name] = torch.autograd.grad(fn(*leaves), leaves, dy.to(dtype))
    abs_err = _grads_line(
        f"ConvValid grads {tag} D={d} M={m} vs autograd through F.conv2d",
        [("dx", grads["fn"][0], grads["f32"][0], None),
         ("dw", grads["fn"][1], grads["f32"][1], None),
         ("dx vs float64", grads["fn"][0], grads["f64"][0], TOL_K2),
         ("dw vs float64", grads["fn"][1], grads["f64"][1], TOL_K2_DW)],
        TOL_K2)
    return rows, max(abs_err, *(r["abs"] for r in rows.values()))


def pool_resizes(nx: int, layers: int, depth: int = 10):
    """(channels, (nx, ny, nxs, nys)) of each resize of a fft step of the
    default net, or of the net whose stages are ``depth`` channels wide:
    the encoder pools each stage's input, the decoder each stage's
    output."""
    from spectralae_torch.core.config import Config, LayerParams
    from spectralae_torch.core.types import initial_spec
    cfg = Config(nx=nx, ny=nx, layer=LayerParams(depth=depth))
    spec = initial_spec(cfg)
    for _ in range(layers - 1):
        spec = spec.add_pair(cfg.layer)
    out, n, half = [], nx, len(spec.stages) // 2
    for i, s in enumerate(spec.stages):
        if abs(s.scale) > 1:
            m = n // s.scale if s.scale > 0 else n * -s.scale
            out.append((s.d if i < half else s.m, (n, n, m, m)))
            n = m
    return out


def rs_step(gen, nx: int, batch: int, depth: int = 10) -> tuple[dict, dict]:
    """The resize kernel at each launch of one fft train step on ``nx``^2
    frames: each resize forward, and each adjoint but the frames' (which
    need no gradient).  Each launch is held against the plain version
    (``resize_plain``: two gathers and a mask multiply) and against itself
    run again, both bit for bit, and timed beside it and the bound (every
    kept input bin read once, every output bin written once); the adjoint's
    library call is the gradient the port took before the kernel (autograd
    through the gathers: a mask multiply, two ``index_add`` into
    zero-filled buffers).  Returns the rows by launch key (each with its
    part of the step and its bytes) and the step's sums."""
    from spectralae_torch.ops import resize_kernels as rk
    from spectralae_torch.ops import spectral
    tag = f"{nx}x{nx} b{batch}" + ("" if depth == 10 else f" M={depth}")
    rows = {}
    for i, (ch, dims) in enumerate(pool_resizes(nx, 3, depth)):
        for adjoint in (False, True)[:2 if i else 1]:
            h_in, w_in, h_out, w_out = rk.resize_dims(*dims, adjoint)
            x = torch.randn(batch, ch, h_in, w_in, dtype=torch.complex64,
                            device="cuda", generator=gen)
            got = rk.spectral_resize(x, *dims, adjoint=adjoint)
            again = rk.spectral_resize(x, *dims, adjoint=adjoint)
            want = spectral.resize_plain(x, *dims, adjoint)
            label = (f"resize {'adjoint' if adjoint else 'forward'} {tag} "
                     f"[{ch}, {h_in}, {w_in}] -> [{h_out}, {w_out}]")
            check(torch.equal(got, want), f"{label}: not the plain "
                  "version's bit for bit")
            check(torch.equal(torch.view_as_real(got).view(torch.int32),
                              torch.view_as_real(again).view(torch.int32)),
                  f"{label} does not repeat bit for bit")
            library = True
            if adjoint:
                big = torch.randn(batch, ch, h_out, w_out,
                                  dtype=torch.complex64, device="cuda",
                                  generator=gen, requires_grad=True)
                fwd = spectral.resize_plain(big, *dims)

                def library(fwd=fwd, big=big, x=x):
                    return torch.autograd.grad(fwd, big, x,
                                               retain_graph=True)
            rows_map, cols_map = spectral._remap_maps(*dims, adjoint)
            kept = int((rows_map >= 0).sum()) * int((cols_map >= 0).sum())
            nbytes = 8.0 * batch * ch * (kept + h_out * w_out)
            row = measure(
                label, got, want,
                lambda x=x, dims=dims, a=adjoint: rk.spectral_resize(
                    x, *dims, adjoint=a),
                lambda x=x, dims=dims, a=adjoint: spectral.resize_plain(
                    x, *dims, a),
                bound_ms(0.0, nbytes), 0.0, library=library,
                extra=f"; bit for bit; {nbytes / 1e6:.1f} MB")
            row.update(part="bwd" if adjoint else "fwd", bytes=nbytes,
                       tb_per_s=nbytes / row["ms"] / 1e9)
            rows[rs_key(x, *dims, adjoint)] = row
            del x, got, again, want, library
    step = {k: sum(r[k] for r in rows.values())
            for k in ("ms", "plain_ms", "bound_ms", "library_ms", "bytes")}
    step["tb_per_s"] = step["bytes"] / step["ms"] / 1e9
    step["roofline_pct"] = 100 * step["bound_ms"] / step["ms"]
    print(f"resize, a fft step at {tag} ({len(rows)} launches): kernel "
          f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, the "
          f"gathers and index_add gradients {step['library_ms']:.4f} ms, "
          f"bound {step['bound_ms']:.4f} ms ({step['roofline_pct']:.1f} %, "
          f"{step['tb_per_s']:.2f} TB/s)", flush=True)
    return rows, step


def rs_host_us(gen) -> dict:
    """Host microseconds a call of the resize's routes at the 256^2 b8
    step's smallest pooling ([8, 10, 64, 33] -> [32, 17], a few device
    microseconds, so the loop is paced by the host): the route with a
    gradient (the autograd Function), without one (the wrapper), and the
    plain gathers, forward and forward plus backward; the median of three
    loops of 300 calls."""
    from spectralae_torch.ops import spectral
    x = torch.randn(8, 10, 64, 33, dtype=torch.complex64, device="cuda",
                    generator=gen)
    xg = x.clone().requires_grad_(True)
    g = torch.randn(8, 10, 32, 17, dtype=torch.complex64, device="cuda",
                    generator=gen)

    def both(fn):
        return lambda: torch.autograd.grad(fn(xg, 64, 64, 32, 32), xg, g)
    calls = {
        "route_fwd": lambda: spectral.spectral_resize(xg, 64, 64, 32, 32),
        "route_nograd": lambda: spectral.spectral_resize(x, 64, 64, 32, 32),
        "plain_fwd": lambda: spectral.resize_plain(xg, 64, 64, 32, 32),
        "route_fwd_bwd": both(spectral.spectral_resize),
        "plain_fwd_bwd": both(spectral.resize_plain)}
    out = {}
    for name, fn in calls.items():
        loops = []
        for _ in range(3):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(300):
                fn()
            torch.cuda.synchronize()
            loops.append((time.perf_counter() - t0) / 300 * 1e6)
        out[name] = sorted(loops)[1]
    print("resize host us a call at [8, 10, 64, 33] -> [32, 17]: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out.items()), flush=True)
    return out


def phase_kernels(gen: torch.Generator) -> tuple[dict, dict]:
    """Every stage shape at both sizes; returns each kernel's timed rows by
    launch key and its largest absolute error.  Also B2, the unbatched
    form, once."""
    from spectralae_torch.ops import spectral
    from spectralae_torch.ops import spectral_kernels as sk
    timed = {"k1": {}, "k1bf": {}, "k2": {}, "rs": {}}
    errs = {"k1": 0.0, "k1bf": 0.0, "k2": 0.0, "rs": 0.0}
    for nx, batch in ((256, 8), (1024, 4)):
        for n, d, m in sorted(set(stage_shapes(nx, 3))):
            for kern, fn in (("k1", k1_shape), ("k2", k2_shape)):
                rows, err = fn(gen, n, batch, d, m)
                timed[kern].update(rows)
                errs[kern] = max(errs[kern], err)
            if nx == 256:
                # K1's bf16 operands at the launch shapes of a bf16 step
                rows, err = k1_shape(gen, n, batch, d, m, bf16=True)
                timed["k1bf"].update(rows)
                errs["k1bf"] = max(errs["k1bf"], err)
    # K1 at every launch shape of the benchmark's fft steps (M = 50 at
    # 1024^2 b16, M = 10 at 1024^2 b64), whose wide launches take the
    # blocked design, in complex64 and with bf16 operands
    for nx, batch, depth in BENCH_FFT_STEPS:
        for n, d, m in sorted(set(stage_shapes(nx, 3, depth))):
            for kern, bf16 in (("k1", False), ("k1bf", True)):
                _, err = k1_shape(gen, n, batch, d, m, bf16=bf16)
                errs[kern] = max(errs[kern], err)
    # the resize at every launch of a fft step: the default net at both
    # sizes (the 256^2 b8 rows feed the per-step sums), then the
    # benchmark's fft steps; its host cost a call
    timed["rs_steps"] = {}
    for nx, batch, depth in ((256, 8, 10), (1024, 4, 10)) + BENCH_FFT_STEPS:
        rows, timed["rs_steps"][f"{nx}x{nx} b{batch} M={depth}"] = rs_step(
            gen, nx, batch, depth)
        timed["rs"].update(rows)
        errs["rs"] = max(errs["rs"], *(r["abs"] for r in rows.values()))
    timed["rs_host_us"] = rs_host_us(gen)
    # B2, the unbatched spectral_conv_pallas: K1 at batch 1, at stage 0's
    # shape of a 256^2 frame (no path of the port calls it)
    n, d, m = stage_shapes(256, 3)[0]
    nyr = n // 2 + 1
    X1 = torch.fft.rfft2(torch.randn(d, n, n, device="cuda", generator=gen))
    C1 = torch.randn(m, d, n, nyr, dtype=torch.complex64, device="cuda",
                     generator=gen)
    b1 = torch.randn(m, device="cuda", generator=gen)
    measure(f"B2 spectral_conv_pallas {n}x{n} b1 D={d} M={m} (K1 at A=1)",
            sk.spectral_conv_pallas(X1, C1, b1, n, n),
            spectral.spectral_conv_einsum(X1[None], C1, b1, n, n)[0],
            lambda: sk.spectral_conv_pallas(X1, C1, b1, n, n),
            lambda: spectral.spectral_conv_einsum(X1[None], C1, b1, n, n),
            k1_bound(1, d, m, n * nyr, bias=True), TOL_K1)
    n, d, m = stage_shapes(256, 3)[-1]
    stage5 = timed["k2"][(8, m, n + 8, n + 8), (d, m, 5, 5)]
    print(f"stage-5 data grad at 256x256 b8 ({m}->{d} at {n + 8}^2): K2 "
          f"{stage5['ms']:.4f} ms, F.conv2d {stage5['plain_ms']:.4f} ms "
          f"(device); training routes it to F.conv2d "
          "(PALLAS_DATA_GRAD = False)", flush=True)
    return timed, errs


def per_step(timed: dict, launched: dict) -> dict:
    """Each kernel's ms, plain_ms, bound_ms and library_ms in one 256^2
    batch-8 train step, forward and backward: the sums of the rows timed
    at the keys of the launches such a step made (``launched``)."""
    out = {}
    for kern, keys in launched.items():
        tot = dict.fromkeys(("fwd_ms", "fwd_plain_ms", "bwd_ms",
                             "bwd_plain_ms", "ms", "plain_ms", "bound_ms",
                             "library_ms"), 0.0)
        for key in keys:
            r = timed[kern].get(key)
            check(r is not None, f"{kern}: a train step launched it at "
                  f"{key}, which no row of phase 3 timed")
            tot[f"{r['part']}_ms"] += r["ms"]
            tot[f"{r['part']}_plain_ms"] += r["plain_ms"]
            for name in ("ms", "plain_ms", "bound_ms"):
                tot[name] += r[name]
            # no library call for one launch: none for the step
            if r["library_ms"] is None or tot["library_ms"] is None:
                tot["library_ms"] = None
            else:
                tot["library_ms"] += r["library_ms"]
        tot["bound_by"] = max((timed[kern][k] for k in keys),
                              key=lambda r: r["bound_ms"])["bound_by"]
        tot["ms_source"] = _sources(timed[kern][k] for k in keys)
        out[kern] = tot
    return out


def _net(nx: int):
    from spectralae_torch.core.config import Config
    from spectralae_torch.core.types import init_params, initial_spec
    cfg = Config(nx=nx, ny=nx)
    spec = initial_spec(cfg)
    for _ in range(2):
        spec = spec.add_pair(cfg.layer)
    params = init_params(torch.Generator().manual_seed(0), spec,
                         cfg.layer.rmax, device="cuda")
    return params, spec


def _breakdown(label: str, fn, extra: str = "",
               reps: int = REPS) -> tuple[float, float]:
    """Host ms per call of ``fn`` (a synchronised loop), device ms, the
    device's busy share and the top device kernels; then, from a second
    profile that also traces the host, the host operations that take the
    most time of their own (inflated by the tracing, so only their order
    and shares are read).  Returns (host ms, device ms) per call."""
    for _ in range(min(3, reps)):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    rows = sorted(((ms * k, key) for key, ms, k, _ in device_ops(fn, reps)),
                  reverse=True)
    dev = sum(t for t, _ in rows)
    top = "; ".join(f"{name[:48]} {t:.4f}" for t, name in rows[:6])
    print(f"{label}: host {wall:.4f} ms, device {dev:.4f} ms (busy "
          f"{dev / wall:.1%}){extra}; top ms: {top}", flush=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    host = sorted(((e.self_cpu_time_total / reps / 1e3, e.count // reps,
                    e.key) for e in prof.key_averages()), reverse=True)
    total = sum(t for t, _, _ in host)
    top = "; ".join(f"{name[:40]} x{n} {t / total:.0%}"
                    for t, n, name in host[:8])
    print(f"{label}: host ops traced {total:.2f} ms per call, "
          f"{sum(n for _, n, _ in host)} op calls; top self time: {top}",
          flush=True)
    return wall, dev


def phase_forward() -> None:
    """Host and device time of whole forwards, and where the device time
    goes (kernels by name); a fft forward launches the resize at each of
    its 6 poolings, a coord forward none."""
    from spectralae_torch.model import autoencoder as model
    for nx, batch in ((256, 8), (1024, 4)):
        params, spec = _net(nx)
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
                before = counts()
                fwd()
                torch.cuda.synchronize()
                grew = grown(before)["rs"]
                want = RS_PER_FFT_FORWARD if domain == "fft" else 0
                check(grew == want, f"forward {domain}: launched the resize "
                      f"{grew}x; expected {want}")
                _breakdown(f"forward {domain} {nx}x{nx} b{batch}", fwd,
                           f", launches resize {grew}")


def phase_train_step() -> dict:
    """The same for whole train steps (forward, backward and the inertia
    update), in float32 and with bf16 operands (``compute_dtype``), with
    the kernels' launches per step and the peak memory.  Returns the keys
    of the launches of one 256^2 batch-8 step: K1's and the resize's from
    the fft domain (``k1`` and ``rs``, and ``k1bf`` from the bf16 step) and
    K2's from the coord domain."""
    from spectralae_torch.core.types import init_opt_state
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.train.modern import train_step
    launched = {}
    for nx, batch in ((256, 8), (1024, 4)):
        params, spec = _net(nx)
        opt = init_opt_state(params)
        x = torch.rand(batch, 3, nx, nx, device="cuda") * 255
        for domain, cd in itertools.product(("fft", "coord"),
                                            (None, torch.bfloat16)):
            def step():
                return train_step(params, opt, x, spec.scales, domain=domain,
                                  compute_dtype=cd)
            tag = "" if cd is None else " bf16"
            before = counts()
            with launch_log() as log:
                step()
            torch.cuda.synchronize()
            g = grown(before)
            grew = (g["k1"], g["k1bf"], g["k2"], g["rs"])
            want = [0, 0, K2_PER_COORD_STEP, 0]
            if domain == "fft":
                want = [0, 0, 0, RS_PER_FFT_STEP]
                want[0 if cd is None else 1] = K1_PER_FFT_STEP
            check(grew == tuple(want), f"train step {domain}{tag}: "
                  f"launched K1 {grew[0]}x, K1 bf16 {grew[1]}x, K2 "
                  f"{grew[2]}x, the resize {grew[3]}x; expected {want}")
            check(grew[0] + grew[1] == len(log["k1"])
                  and grew[2] == len(log["k2"]) and grew[3] == len(log["rs"]),
                  f"train step {domain}{tag}: counted {grew}, logged "
                  f"{len(log['k1'])}, {len(log['k2'])} and "
                  f"{len(log['rs'])} launches")
            if nx == 256 and not (domain == "coord" and cd is not None):
                kern = ("k2" if domain == "coord"
                        else "k1" if cd is None else "k1bf")
                launched[kern] = log["k2" if kern == "k2" else "k1"]
                if kern == "k1":
                    launched["rs"] = log["rs"]
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**20
            _breakdown(f"train step {domain}{tag} {nx}x{nx} b{batch}", step,
                       f", launches K1 {grew[0]} K1 bf16 {grew[1]} K2 "
                       f"{grew[2]} resize {grew[3]}, peak {peak:.1f} MiB")
        # the data grad of the 10->3 stage through K2 adds one launch
        route, ck.PALLAS_DATA_GRAD = ck.PALLAS_DATA_GRAD, True
        try:
            before = counts()
            train_step(params, opt, x, spec.scales, domain="coord")
            torch.cuda.synchronize()
            grew = grown(before)["k2"]
        finally:
            ck.PALLAS_DATA_GRAD = route
        print(f"train step coord {nx}x{nx} b{batch} with PALLAS_DATA_GRAD: "
              f"K2 launches {grew}", flush=True)
        check(grew == K2_PER_COORD_STEP + 1,
              f"coord step with the K2 data grad launched K2 {grew}x")
    return launched


# ------------------------------------------------ P1, P2: the probes

def _sector_bytes(x: torch.Tensor, reads) -> float:
    """The bytes of the 32-byte sectors of contiguous ``x`` that hold the
    elements ``reads(x)`` selects: the least the card moves to read them
    (every fourth float of a row touches every sector, every fourth row
    only its own)."""
    idx = reads(torch.arange(x.numel()).reshape(x.shape))
    return 32.0 * torch.unique(idx * x.element_size() // 32).numel()


def _script(name: str):
    """``scripts/<name>.py`` of this checkout, loaded as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_smoke_{name}", Path(__file__).resolve().parent / "scripts"
        / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_probes() -> tuple[dict, dict, dict]:
    """The probes' own entry points on the card, each a path with its
    launches counted: ``scripts/torch_probe_mosaic_features.py`` (three
    ``OK maxerr=0.0`` lines) and ``scripts/torch_probe_fused_dft.py``
    (``--check`` on the card, then ``--n 2048``, which times the kernel
    beside ``torch.fft.rfft``).  Then each kernel against its plain version
    and a PyTorch call on the same inputs: P1 exact on the JAX probe's
    inputs, P2 at [3, 2048, 2048].  The bounds count what each function
    needs: P1 the 32-byte sectors of the input its reads touch, P2 ``x``
    read once or a real FFT a row (the script's ``bound``; the matmul DFT's
    own operations are printed beside it).  Returns the rows, the largest
    absolute errors and the paths' launches."""
    from spectralae_torch.ops import fft_kernels as fk
    from spectralae_torch.ops import probe_kernels as pk
    paths = {}
    mosaic = _script("torch_probe_mosaic_features")
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mosaic.main(["--device", "cuda"])
    print(buf.getvalue(), end="", flush=True)
    check(rc == 0 and buf.getvalue().splitlines() == [
        f"{name}: OK maxerr=0.0" for _, name, _ in P1_ROWS],
        f"the mosaic probes: exit {rc}")
    paths["probe_mosaic"] = counts()
    reset_counts()
    dft = _script("torch_probe_fused_dft")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = (dft.main(["--check", "--device", "cuda"])
              or dft.main(["--n", str(P2_N), "--reps", "5"]))
    for line in buf.getvalue().splitlines():
        print(f"torch_probe_fused_dft: {line}", flush=True)
    check(rc == 0, f"the fused-DFT probe: exit {rc}")
    paths["probe_dft"] = counts()

    rows, errs = {}, {}
    for key, name, _ in P1_ROWS:
        fn, x_np, _ = mosaic.CASES[name]
        x = torch.from_numpy(x_np).cuda()
        plain = getattr(pk, f"{name}_plain")
        if name == "middle_store":
            kcol = torch.arange(1, 5, dtype=x.dtype, device="cuda")[
                :, None, None]
            library = lambda x=x, kcol=kcol: x[None] * kcol  # noqa: E731
        else:
            library = True      # the plain version is one strided multiply
        got = fn(x)
        nbytes = _sector_bytes(x, P1_READS[name]) + 4.0 * got.numel()
        rows[key] = measure(
            f"P1 {name} {tuple(x.shape)} -> {tuple(got.shape)}", got,
            plain(x), lambda fn=fn, x=x: fn(x),
            lambda plain=plain, x=x: plain(x),
            bound_ms(float(got.numel()), nbytes), 0.0, library=library)
        errs[key] = rows[key]["abs"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(3, P2_N, P2_N, device="cuda", generator=gen)
    d, nx, ny = x.shape
    ref = pk.ref_energy(x)
    b = dft.bound(x.shape)
    lib = _library_ms(lambda: pk.ref_energy(x))
    rows["p2"], errs["p2"] = {}, 0.0
    for prec in fk.TIERS:
        got = pk.ydft_energy(x, precision=prec)
        err_ref = rel_err(got, ref)
        tol_ref = fk.p2_tier_tol(prec, x.numel())
        check(err_ref <= tol_ref, f"P2 {prec} against torch.fft.rfft: rel "
              f"{err_ref:.3e}")
        row = measure(
            f"P2 ydft_energy {prec} [{d}, {nx}, {ny}]", got,
            pk.ydft_energy_plain(x, precision=prec),
            lambda p=prec: pk.ydft_energy(x, precision=p),
            lambda p=prec: pk.ydft_energy_plain(x, precision=p),
            (b["bound_ms"], b["bound_by"]), TOL_P2, library=lib,
            extra=f"; vs torch.fft.rfft {err_ref:.3e} (tol {tol_ref:g}); "
                  f"figures of the design: the matmul DFT's operations at "
                  f"the float32 peak {b['matmul_dft_ms']:.4f} ms, on the "
                  f"tensor cores at this tier "
                  f"{b['tensor_core_ms'][prec]:.4f} ms")
        row["vs_ref"] = err_ref
        rows["p2"][prec] = row
        errs["p2"] = max(errs["p2"], row["abs"])
        print(f"P2 {prec}: {'beats' if row['ms'] < lib else 'does not beat'}"
              f" torch.fft.rfft and the weighted sum ({row['ms']:.4f} "
              f"against {lib:.4f} ms)", flush=True)
    return rows, errs, paths


# ------------------------------------------------ K3, K4 and the bursts

K3_GRIDS = K4_GRIDS = ("window_rows_kernel", "window_reduce_kernel")


def _xstage_flops(hx: int, hy: int) -> int:
    """Flops of one x-row's x-stage for one pair at +-hx, +-hy: the four
    sums of csrc/corr_windows.cu per (u, v >= 0), less those whose sine is
    0 (u = 0 or v = 0)."""
    return 2 * (1 + 2 * hx + 2 * hy + 4 * hx * hy)


def k3_bound(b: int, d: int, e: int, n: int, h: int, same: bool):
    """K3 on [B, D, n, nyr] x [B, E, n, nyr] complex64 at window +-h: the
    inputs read once (one when Z is X), the windows written once; per bin
    and batch 6 flops per pair product and its y-stage, 4 + 8h flops (the
    lags +-v share their cosine: 4 multiply-adds per v >= 1, 2 at v = 0);
    per x-row the x-stage (``_xstage_flops``).  When Z is X only the
    D(D+1)/2 pairs d <= e are needed (the others are their mirrors)."""
    nyr, v = n // 2 + 1, 2 * h + 1
    bins = b * n * nyr
    pairs = d * (d + 1) // 2 if same else d * e
    return bound_ms(bins * pairs * (6 + 4 + 8 * h)
                    + n * pairs * _xstage_flops(h, h),
                    8 * bins * (d if same else d + e) + 4 * d * e * v * v)


def k4_bound(b: int, d: int, n: int, nk2: int, bf16: bool,
             rows: int | None = None):
    """K4 on [B, D, n, nyr] (complex64, or bf16 re/im planes), square taps
    nk2 = 2h + 1: per bin and batch EG (8·D² + 8·D flops), the pair
    products (6 each) and the y-stage (4 + 8·hy a pair, as K3's); per bin
    the anchor spectra from the taps folded over +-ly (8·h flops an entry
    of D², plus its DC term); per x-row the taps contracted over kx (4
    flops a tap and entry) and the x-stage of both windows.  ``rows``: a
    row slab's live rows of the n-row grid (the work of those rows)."""
    nyr, h = n // 2 + 1, nk2 // 2
    rows = n if rows is None else rows
    nxx, neg = d * (d + 1) // 2, d * d
    bins = b * rows * nyr
    per_bin = (8 * d * d + 8 * d + 6 * (nxx + neg)
               + nxx * (4 + 16 * h) + neg * (4 + 8 * h))
    flops = (bins * per_bin + rows * nyr * d * d * (8 * h + 2)
             + rows * (d * d * nk2 * nk2 * 4
                       + nxx * _xstage_flops(2 * h, 2 * h)
                       + neg * _xstage_flops(h, h)))
    v4, v2 = 2 * nk2 - 1, nk2
    nbytes = ((4 if bf16 else 8) * bins * d + 4 * d * d * nk2 * nk2
              + 4 * (d * d * (v4 * v4 + v2 * v2) + 1 + d))
    return bound_ms(flops, nbytes)


def window_plan_text(anchor: bool, X, n: int, d: int, e: int, h: int,
                     same: bool = False) -> str:
    """The launch plan K3's or K4's wrapper takes at this shape
    (``window_kernels.window_plan``)."""
    from spectralae_torch.ops import window_kernels as wk
    p = wk.window_plan(anchor, X.shape[0], d, e, n, n // 2 + 1, h, h, same)
    return (f"; plan {p.rows} rows x {p.batches} batches x {p.ychunk} bins "
            f"a block, steps of {p.ytile}, {p.threads} threads, grid "
            f"{p.grid}")


def windows_repeated(fn, label: str) -> torch.Tensor:
    """One K3 or K4 launch, run twice more and held bit for bit (fixed
    sums, no atomics)."""
    runs = [fn() for _ in range(3)]
    runs = [_flat(r) if isinstance(r, tuple) else r for r in runs]
    check(all(torch.equal(runs[0], r) for r in runs[1:]),
          f"{label} does not repeat")
    return runs[0]


def _grid_times(label: str, fn, names) -> None:
    """Print the device ms of each of a kernel's grids in one call."""
    print(f"{label} grids: " + ", ".join(
        f"{n} {device_ms(fn, (n,)):.4f} ms" for n in names), flush=True)


def _flat(outs) -> torch.Tensor:
    return torch.cat([o.reshape(-1) for o in outs])


def phase_windows(gen: torch.Generator) -> tuple[dict, dict]:
    """K3 and K4 against their plain versions at the precompute shapes of
    pair 0 at each of WINDOW_SIZES.  K3 at its two launches of the unfused
    precompute (XX: Z is X at +-4h; EG: Z the 2·D error planes at +-2h),
    with one einsum over complex bases as its library call; K4 with the
    float32 and the bf16 signal (no single PyTorch call computes it).
    Returns the rows by (kernel, frame size, variant) and each kernel's
    largest absolute error."""
    from spectralae_torch.ops import dft
    from spectralae_torch.ops import window_kernels as wk
    from spectralae_torch.train import fft_corr
    # random pair-0 kernels of the default net (M=10, D=3, 5x5)
    m, d, nk = 10, 3, 5
    c, f = ((torch.rand(*shape, device="cuda", generator=gen) - 0.5)
            for shape in ((m, d, nk, nk), (d, m, nk, nk)))
    taps = fft_corr._composed_taps(c, f, fft_corr._maps_on(nk, nk, c.device),
                                   d, m, nk * nk)
    nk2 = taps.shape[-1]
    h2, s1 = nk2 // 2, 1.0 / (m * d)
    rows, errs = {}, {"k3": 0.0, "k4": 0.0}
    for frames, batch in WINDOW_SIZES:
        n = frames // 2
        tag = f"{n}x{n} b{batch} ({frames}^2 frames)"
        X = torch.fft.rfft2(torch.rand(batch, d, n, n, device="cuda",
                                       generator=gen) * 255)
        Z = torch.fft.rfft2(torch.randn(batch, 2 * d, n, n, device="cuda",
                                        generator=gen) * 50)
        for variant, Zs, h in (("xx", X, 2 * h2), ("eg", Z, h2)):
            bxc, bxs, byc, bys = (torch.as_tensor(a, device="cuda")
                                  for a in dft.lag_basis(n, n, h, h))
            ex, ey = torch.complex(bxc, bxs), torch.complex(byc, bys)

            def lib(Zs=Zs, ex=ex, ey=ey):
                return torch.einsum("bdxy,bexy,xu,yv->deuv", X.conj(), Zs,
                                    ex, ey).real / batch
            want = wk.corr_pair_windows_plain(X, Zs, n, n, h, h)
            lib_err = rel_err(lib(), want)
            check(lib_err <= TOL_WINDOWS, f"K3 library call {tag}: "
                  f"{lib_err:.3e}")
            label = (f"K3 corr_pair_windows {variant} {tag} D={d} "
                     f"E={Zs.shape[1]} +-{h}")
            row = measure(
                label, windows_repeated(
                    lambda Zs=Zs, h=h: wk.corr_pair_windows(X, Zs, n, n, h,
                                                            h), label),
                want, lambda Zs=Zs, h=h: wk.corr_pair_windows(X, Zs, n, n, h,
                                                              h),
                lambda Zs=Zs, h=h: wk.corr_pair_windows_plain(X, Zs, n, n, h,
                                                              h),
                k3_bound(batch, d, Zs.shape[1], n, h, Zs is X), TOL_WINDOWS,
                library=lib, names=K3_GRIDS,
                extra=f"; library vs plain {lib_err:.3e}; three runs bit "
                f"for bit" + window_plan_text(False, X, n, d, Zs.shape[1], h,
                                              Zs is X))
            rows[("k3", frames, variant)] = row
            errs["k3"] = max(errs["k3"], row["abs"])
            _grid_times(f"K3 {variant} {tag}", lambda Zs=Zs, h=h:
                        wk.corr_pair_windows(X, Zs, n, n, h, h), K3_GRIDS)
        for variant, sd in (("f32", None), ("bf16", torch.bfloat16)):
            def kern(sd=sd):
                return wk.anchor_windows(X, taps, n, n, h2, h2, s1,
                                         signal_dtype=sd)

            def plain(sd=sd):
                return wk.anchor_windows_plain(X, taps, n, n, h2, h2, s1,
                                               signal_dtype=sd)
            label = (f"K4 anchor_windows {variant} signal {tag} D={d} taps "
                     f"{nk2}x{nk2}")
            row = measure(
                label, windows_repeated(kern, label), _flat(plain()), kern,
                plain, k4_bound(batch, d, n, nk2, sd is not None),
                TOL_WINDOWS, library=None, names=K4_GRIDS,
                extra="; three runs bit for bit"
                + window_plan_text(True, X, n, d, d, h2))
            rows[("k4", frames, variant)] = row
            errs["k4"] = max(errs["k4"], row["abs"])
            _grid_times(f"K4 {variant} {tag}", kern, K4_GRIDS)
    return rows, errs


# ------------------------------------------ B5: the four-step rfft2

B5_ROWS = (  # counter key, kernel, the Pallas function it replaces
    ("b5a", "rfft_y_mixed", "spectralae/ops/pallas_fft.py:461"),
    ("b5b", "fft_x_mixed", "spectralae/ops/pallas_fft.py:513"),
    ("b5c", "bfly_lanes", "spectralae/ops/pallas_fft.py:300"),
    ("b5d", "bfly_rows", "spectralae/ops/pallas_fft.py:352"),
    ("b5e", "fft_yc", "spectralae/ops/pallas_fft.py:425"))


def b5_round_cost(bd: int, a: int, n: int, real: bool):
    """One butterfly round over ``[bd, a, n]`` (lanes) or ``[bd, n, a]``
    (rows): the input planes read once (one when real), the four twiddled
    streams written once (two float32 planes); 12 float32 operations per
    element, the count of spectralae/core/roofline.py:165-219."""
    elems = bd * a * n
    return 12.0 * elems, 4.0 * elems * ((1 if real else 2) + 2)


def b5_yleaf_cost(bd: int, r: int, n: int, real: bool):
    """What the y-leaf's function needs over ``[bd, r, n]``: an FFT of each
    row, 2.5·n·log2 n flops real and 5·n·log2 n complex (the count of
    scripts/torch_probe_fused_dft.py::work), against the input read once
    and the ``[bd, 4, r, k1p]`` re/im planes written once."""
    from spectralae_torch.ops import fft_kernels as fk
    return ((2.5 if real else 5.0) * bd * r * n * math.log2(n),
            4.0 * bd * r * n * (1 if real else 2)
            + 8.0 * bd * 4 * r * fk._k1p(n))


def b5_xleaf_cost(bd: int, nx: int, lanes: int, out_bytes: int):
    """The x-leaf over ``[bd, nx, L]``: a complex FFT of each lane's
    column, 5·nx·log2 nx flops; the re/im planes read once, the output
    written once."""
    return (5.0 * bd * lanes * nx * math.log2(nx),
            8.0 * bd * nx * lanes + 2.0 * out_bytes * bd * nx * lanes)


def b5_rfft2_cost(bd: int, n: int, out_bytes: int):
    """The whole transform of ``[bd, n, n]``: a real 2-D FFT a plane,
    2.5·n²·log2 n² flops; the frames read once, the mixed planes written
    once."""
    from spectralae_torch.ops import fft_kernels as fk
    return (2.5 * bd * n * n * math.log2(n * n),
            4.0 * bd * n * n + 2.0 * out_bytes * bd * n * fk.ny_padded(n))


def leaf_design_ms(items: int, m1: int, k: int, precision: str) -> float:
    """The leaf design's tensor-core time: four streams of ``[items, 2·m1]
    x [2·m1, 2·k]`` real products, the tier's bf16 passes, at the bf16
    peak — what the matmul DFT costs, not a bound of the function."""
    from spectralae_torch.ops import fft_kernels as fk
    return fk.design_tc_ms(2.0 * items * 2 * m1 * 2 * k * 4, precision)


def _library_ms(fn) -> float:
    """Device ms of one PyTorch call, timed once for every tier."""
    return _checked_ms(device_ms(fn), fn, cuda_ms(fn))[0]


def _mixed_lanes(planes) -> torch.Tensor:
    """A y-leaf's ``[bd, G, r, k1p]`` re/im planes as complex ``[bd, r,
    G·k1p]``: lane g·k1p + k1 holds ω_y = perm_y."""
    re, im = planes
    return torch.complex(re, im).movedim(1, 2).reshape(
        re.shape[0], re.shape[2], -1)


def _vs_fft_y(planes, spectrum: torch.Tensor, n: int) -> float:
    """A leaf's mixed lanes against the natural spectrum along y (cuFFT's),
    on the lanes that hold a bin."""
    from spectralae_torch.ops import fft_kernels as fk
    py = fk.perm_y(n)
    lanes = torch.as_tensor(np.nonzero(py >= 0)[0], device="cuda")
    bins = torch.as_tensor(py[py >= 0], device="cuda")
    return rel_err(_mixed_lanes(planes).index_select(-1, lanes),
                   spectrum.index_select(-1, bins))


def _on_live(planes, live) -> torch.Tensor:
    """The re/im planes as one float32 vector, the dead lanes zeroed."""
    return torch.cat([torch.where(live, a.float(), 0.0).reshape(-1)
                      for a in planes])


def _tier_row(row: dict, precision: str, exact: float, label: str) -> dict:
    """Hold a tier's result against the exact transform and keep the
    comparison in its row."""
    from spectralae_torch.ops import fft_kernels as fk
    check(exact <= fk.TIER_TOL[precision], f"{label} against cuFFT: "
          f"{exact:.3e} > {fk.TIER_TOL[precision]:g}")
    row["vs_cufft"] = exact
    return row


def _chain_err(x: torch.Tensor, precision: str, live) -> float:
    """The whole transform's float32 planes against the whole plain
    pipeline from ``x``: reported, not held (at "default" the x-leaf rounds
    to bf16 a y-stage output that kernel and plain sum in other orders, so
    a value near a rounding boundary moves by 2^-8; the x-stage is held on
    the kernels' own y-stage)."""
    from spectralae_torch.ops import fft_kernels as fk
    return rel_err(_on_live(fk.rfft2_mixed(x, precision=precision), live),
                   _on_live(fk.rfft2_mixed_plain(x, precision=precision),
                            live))


def phase_fft(gen: torch.Generator) -> tuple[dict, dict]:
    """B5 at the stream's shapes: pair 0's input (D=3) at each of
    WINDOW_SIZES, at each tier.  The y-leaf (real input), the x-leaf
    (float32 and bf16 out) and the whole transform against their
    tier-matched plain versions (norm-relative on the live lanes) and
    against cuFFT within the tier's bound (``torch.fft.rfft`` along lanes,
    ``fft`` along rows, ``rfft2``), each timed beside its plain version,
    its library call (timed once a shape), the recounted bound and the
    design's tensor-core time.  Returns the rows by (kernel, frame size,
    tier[, out]) and each kernel's largest absolute error."""
    from spectralae_torch.ops import fft_kernels as fk
    rows, errs = {}, {"b5a": 0.0, "b5b": 0.0}
    for frames, batch in WINDOW_SIZES:
        n = frames // 2
        tag = f"{n}x{n} b{batch} D=3 ({frames}^2 frames)"
        x = torch.rand(batch, 3, n, n, device="cuda", generator=gen) * 255
        xb = x.reshape(-1, n, n)
        bd, k1p = xb.shape[0], fk._k1p(n)
        live = torch.as_tensor(fk.perm_y(n) >= 0, device="cuda")
        live4 = live.reshape(4, 1, k1p)
        spec_y = torch.fft.rfft(xb, dim=-1)
        yr, yi = (a.reshape(-1, n, k1p) for a in fk.rfft_y_mixed_plain(xb))
        yc = torch.complex(yr, yi)
        spec_x = torch.fft.fft(yc, dim=-2)[:, torch.as_tensor(
            fk.perm_x(n), device="cuda")]
        lib = {"b5a": _library_ms(lambda: torch.fft.rfft(xb, dim=-1)),
               "b5b": _library_ms(lambda: torch.fft.fft(yc, dim=-2)),
               "rfft2": _library_ms(lambda: torch.fft.rfft2(x))}
        for prec in fk.TIERS:
            label = f"B5a rfft_y_mixed (y-leaf) {prec} {tag}"
            got = fk._y_leaf(xb, None, prec)
            design = leaf_design_ms(bd * n, n // 4, k1p, prec)
            exact = _vs_fft_y(got, spec_y, n)
            row = measure(
                label, _on_live(got, live4),
                _on_live(fk.rfft_y_mixed_plain(xb, prec), live4),
                lambda p=prec: fk._y_leaf(xb, None, p),
                lambda p=prec: fk.rfft_y_mixed_plain(xb, p),
                bound_ms(*b5_yleaf_cost(bd, n, n, True)), TOL_B5,
                library=lib["b5a"],
                extra=f"; vs cuFFT {exact:.3e} (tol "
                      f"{fk.TIER_TOL[prec]:g}); a figure of the design: its "
                      f"tensor-core time {design:.4f} ms")
            rows[("b5a", frames, prec)] = _tier_row(row, prec, exact, label)
            errs["b5a"] = max(errs["b5a"], row["abs"])
            for variant, od in (("f32", None), ("bf16", torch.bfloat16)):
                label = (f"B5b fft_x_mixed (x-leaf) {prec} {variant} out "
                         f"{tag} {4 * bd} planes x {k1p} lanes")

                def kern(p=prec, od=od):
                    return fk.fft_x_mixed(yr, yi, precision=p, out_dtype=od)

                def plain(p=prec, od=od):
                    return fk.fft_x_mixed_plain(yr, yi, od, p)
                got = kern()
                tol_x = max(fk.TIER_TOL[prec], TOL_B5_BF16 if od else 0.0)
                design = leaf_design_ms(4 * bd * k1p, n // 4, n // 4, prec)
                exact = rel_err(torch.complex(got[0].float(),
                                              got[1].float()), spec_x)
                # bf16 out against the plain float32 planes of its tier:
                # the 2^-9 storage rounding
                row = measure(
                    label, _flat(got).float(),
                    _flat(fk.fft_x_mixed_plain(yr, yi, None, prec)), kern,
                    plain, bound_ms(*b5_xleaf_cost(4 * bd, n, k1p,
                                                   2 if od else 4)),
                    TOL_B5_BF16 if od else TOL_B5, library=lib["b5b"],
                    extra=f"; vs cuFFT {exact:.3e} (tol {tol_x:g}); a "
                          f"figure of the design: its tensor-core time "
                          f"{design:.4f} ms")
                check(exact <= tol_x, f"{label} against cuFFT: {exact:.3e}")
                row["vs_cufft"] = exact
                rows[("b5b", frames, prec, variant)] = row
                errs["b5b"] = max(errs["b5b"], row["abs"])
            # the whole transform, float32 planes at every tier and the
            # bf16 planes of the "fft-bf16" route at its tier
            for variant, od in (("f32", None), ("bf16", torch.bfloat16)):
                if od is not None and prec != ROUTE_TIER["fft-bf16"]:
                    continue
                label = (f"B5 rfft2_mixed (whole transform) {prec} {variant} "
                         f"out {tag}")

                def whole(p=prec, od=od):
                    return fk.rfft2_mixed(x, precision=p, out_dtype=od)
                leaves = device_ms(whole, ("dft_leaf_kernel",))
                nat = rel_err(fk.to_natural(whole(), n, n), torch.fft.rfft2(x))
                chain = _chain_err(x, prec, live)
                row = measure(
                    label, _on_live(whole(), live),
                    _on_live(fk.rfft2_mixed_plain(
                        x, precision=prec,
                        y_planes=fk.rfft_y_mixed(x, precision=prec)), live),
                    whole, lambda p=prec, od=od: fk.rfft2_mixed_plain(
                        x, precision=p, out_dtype=od),
                    bound_ms(*b5_rfft2_cost(bd, n, 2 if od else 4)),
                    TOL_B5_BF16 if od else TOL_B5, library=lib["rfft2"],
                    extra=f"; the plain x-stage on the kernels' y-stage; "
                          f"the whole plain pipeline {chain:.3e}; the two "
                          f"leaves {leaves:.4f} ms of it; natural order vs "
                          f"cuFFT {nat:.3e}")
                check(nat <= max(fk.TIER_TOL[prec],
                                 TOL_B5_BF16 if od else 0),
                      f"{label} natural order against cuFFT: {nat:.3e}")
                row["vs_cufft"] = nat
                rows[("rfft2", frames, prec, variant)] = row
    return rows, errs


def phase_fft_recursion(gen: torch.Generator) -> tuple[dict, dict, dict]:
    """The butterfly rounds and the complex y-leaf (B5c-e), which the
    transform runs only on an axis longer than 4·_MAX_M1 = 2048.  First at
    [2, 3, 256, 256] with ``_MAX_M1`` forced to 8 (two rounds on each axis;
    leaves of m1 = 8, lane counts that are no multiple of 64): each kernel
    against its plain version, the whole transform at each tier against
    its tier-matched plain pipeline on the card and cuFFT.  Then [3, 4096,
    4096] (pair 0's input of 8192^2 frames) at the real ``_MAX_M1``, one
    round on each axis, at each tier: against cuFFT, with its peak memory,
    and each of its kernels timed at the shapes it ran at (B5e at each
    tier).  Returns the rows by kernel (B5e's by tier too), the largest
    absolute errors and the launches of the 4096^2 transform."""
    from spectralae_torch.ops import fft_kernels as fk
    errs = dict.fromkeys(("b5c", "b5d", "b5e"), 0.0)

    def hold(label, key, got, want, tol):
        err = rel_err(_flat(got), _flat(want))
        errs[key] = max(errs[key], float((_flat(got) - _flat(want)).abs()
                                         .max()))
        print(f"{label}: rel {err:.3e} (tol {tol:g})", flush=True)
        check(err <= tol, f"{label} disagrees: {err:.3e}")
    real_max = fk._MAX_M1
    try:
        fk._MAX_M1 = 8
        x = torch.rand(2, 3, 256, 256, device="cuda", generator=gen) * 255
        xb = x.reshape(-1, 256, 256)
        xi = torch.randn(6, 256, 256, device="cuda", generator=gen) * 50
        for kind, im in (("real", None), ("complex", xi)):
            hold(f"B5c bfly_lanes {kind} [6, 256, 256]", "b5c",
                 fk._bfly_lanes(xb, im, 256),
                 fk._bfly_lanes_plain(xb, im, 256), TOL_B5)
        yr, yi = xb.transpose(1, 2).contiguous(), xi.transpose(1, 2)
        hold("B5d bfly_rows [6, 256, 256]", "b5d",
             fk._bfly_rows(yr, yi.contiguous(), 256),
             fk._bfly_rows_plain(yr, yi, 256), TOL_B5)
        zr, zi = xb.reshape(-1, 256, 32), xi.reshape(-1, 256, 32)
        for prec in fk.TIERS:
            hold(f"B5e fft_yc (complex y-leaf) {prec} [48, 256, 32]", "b5e",
                 fk._y_leaf(zr, zi, prec), fk._fft_yc_plain(zr, zi, prec),
                 TOL_B5)
        live = torch.as_tensor(fk.perm_y(256) >= 0, device="cuda")
        for prec, od in [(p, None) for p in fk.TIERS] + [
                (ROUTE_TIER["fft-bf16"], torch.bfloat16)]:
            before = counts()
            got = fk.rfft2_mixed(x, precision=prec, out_dtype=od)
            torch.cuda.synchronize()
            grew = grown(before)
            want = fk.rfft2_mixed_plain(
                x, precision=prec,
                y_planes=fk.rfft_y_mixed(x, precision=prec))
            err = rel_err(_on_live(got, live), _on_live(want, live))
            nat = rel_err(fk.to_natural(got, 256, 256), torch.fft.rfft2(x))
            tol = TOL_B5_BF16 if od else TOL_B5
            tol_nat = max(fk.TIER_TOL[prec], TOL_B5_BF16 if od else 0.0)
            print(f"B5 rfft2_mixed [2, 3, 256, 256] at _MAX_M1 = 8, {prec}, "
                  f"{'bf16' if od else 'f32'} out: card vs its tier's plain "
                  f"x-stage on the card's y-stage rel {err:.3e} (tol "
                  f"{tol:g}; the whole plain pipeline "
                  f"{_chain_err(x, prec, live):.3e}), natural order vs "
                  f"cuFFT {nat:.3e} (tol {tol_nat:g}); launches {grew}",
                  flush=True)
            check(err <= tol and nat <= tol_nat, "forced recursion disagrees")
            check(grew["b5c"] == 2 and grew["b5d"] == 2 and grew["b5e"] == 1
                  and grew["b5b"] == 1 and grew["b5a"] == 0,
                  f"forced recursion launched {grew}")
    finally:
        fk._MAX_M1 = real_max

    n = RECURSION_N
    tag = f"[3, {n}, {n}] (8192^2 frames' pair-0 input, b1)"
    x4 = torch.rand(3, n, n, device="cuda", generator=gen) * 255
    cufft_ms = device_ms(lambda: torch.fft.rfft2(x4))
    nat_ref = torch.fft.rfft2(x4)
    launched, whole = None, {}
    for prec in fk.TIERS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = counts()
        got = fk.rfft2_mixed(x4, precision=prec)
        torch.cuda.synchronize()
        launched = grown(before)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        err = rel_err(fk.to_natural(got, n, n), nat_ref)
        del got
        whole[prec] = {"ms": device_ms(lambda p=prec: fk.rfft2_mixed(
            x4, precision=p)), "vs_cufft": err, "cufft_ms": cufft_ms}
        print(f"B5 rfft2_mixed {tag} {prec}: natural order vs cuFFT rel "
              f"{err:.3e} (tol {fk.TIER_TOL[prec]:g}); launches "
              f"{launched}; peak {peak:.1f} MiB above the input; device "
              f"{whole[prec]['ms']:.4f} ms, cuFFT {cufft_ms:.4f} ms",
              flush=True)
        check(err <= fk.TIER_TOL[prec], f"rfft2_mixed {tag} {prec}: "
              f"{err:.3e}")
        check(launched["b5c"] == 1 and launched["b5d"] == 1
              and launched["b5e"] == 1 and launched["b5b"] == 1
              and launched["b5a"] == 0, f"{tag} launched {launched}")
    del nat_ref
    rows = {"rfft2_4096": whole}
    m = n // 4
    rows["b5c"] = measure(
        f"B5c bfly_lanes (real lane round) [3, {n}, {n}]",
        _flat(fk._bfly_lanes(x4, None, n)),
        _flat(fk._bfly_lanes_plain(x4, None, n)),
        lambda: fk._bfly_lanes(x4, None, n),
        lambda: fk._bfly_lanes_plain(x4, None, n),
        bound_ms(*b5_round_cost(3, n, n, True)), TOL_B5, library=None)
    zr, zi = (a.reshape(-1, n, m) for a in fk._bfly_lanes(x4, None, n))
    zc = torch.complex(zr, zi)
    k1p = fk._k1p(m)
    live = torch.as_tensor(fk.perm_y(m) >= 0, device="cuda").reshape(
        4, 1, -1)
    spec = torch.fft.fft(zc, dim=-1)
    lib = _library_ms(lambda: torch.fft.fft(zc, dim=-1))
    rows["b5e"] = {}
    for prec in fk.TIERS:
        label = f"B5e fft_yc (complex y-leaf) {prec} [12, {n}, {m}]"
        got = fk._y_leaf(zr, zi, prec)
        exact = _vs_fft_y(got, spec, m)
        design = leaf_design_ms(12 * n, m // 4, k1p, prec)
        row = measure(
            label, _on_live(got, live),
            _on_live(fk._fft_yc_plain(zr, zi, prec), live),
            lambda p=prec: fk._y_leaf(zr, zi, p),
            lambda p=prec: fk._fft_yc_plain(zr, zi, p),
            bound_ms(*b5_yleaf_cost(12, n, m, False)), TOL_B5, library=lib,
            extra=f"; library: all m bins of each stream; vs cuFFT "
                  f"{exact:.3e} (tol {fk.TIER_TOL[prec]:g}); a figure of "
                  f"the design: its "
                  f"tensor-core time {design:.4f} ms")
        rows["b5e"][prec] = _tier_row(row, prec, exact, label)
        errs["b5e"] = max(errs["b5e"], row["abs"])
    del got, spec
    sr, si = fk._y_leaf(zr, zi, ROUTE_TIER["fft"])
    yr, yi = sr.reshape(-1, n, k1p), si.reshape(-1, n, k1p)
    del zc, sr, si
    rows["b5d"] = measure(
        f"B5d bfly_rows (row round) [{yr.shape[0]}, {n}, {k1p}]",
        _flat(fk._bfly_rows(yr, yi, n)),
        _flat(fk._bfly_rows_plain(yr, yi, n)),
        lambda: fk._bfly_rows(yr, yi, n),
        lambda: fk._bfly_rows_plain(yr, yi, n),
        bound_ms(*b5_round_cost(yr.shape[0], k1p, n, False)), TOL_B5,
        library=None)
    for key in ("b5c", "b5d"):
        errs[key] = max(errs[key], rows[key]["abs"])
    return rows, errs, launched


def phase_windows_mixed(gen: torch.Generator) -> dict:
    """K4 on the four-step FFT's mixed planes (float32 and bf16, gathered
    to natural order first) against its plain version and against K4 on
    cuFFT's spectra of the same frames, at WINDOW_SIZES, with the gather's
    own device ms; then the fused precompute through the "fft" and
    "fft-bf16" routes against the default route: T dicts, host ms (in
    turns) and device ms.  Returns the rows by (frame size, variant)."""
    from spectralae_torch.ops import fft_kernels as fk
    from spectralae_torch.ops import window_kernels as wk
    from spectralae_torch.train import fft_corr
    params, _ = _net(256)
    enc, dec = params.pair(0)
    w = (enc.c, dec.c, enc.b, dec.b)
    d, m, nk = 3, 10, 5
    taps = fft_corr._composed_taps(enc.c, dec.c,
                                   fft_corr._maps_on(nk, nk, enc.c.device),
                                   d, m, nk * nk)
    nk2 = taps.shape[-1]
    h2, s1 = nk2 // 2, 1.0 / (m * d)
    rows = {}
    for frames, batch in WINDOW_SIZES:
        n = frames // 2
        tag = f"{n}x{n} b{batch} ({frames}^2 frames)"
        x = torch.rand(batch, d, n, n, device="cuda", generator=gen) * 255
        natural = _flat(wk.anchor_windows(torch.fft.rfft2(x), taps, n, n, h2,
                                          h2, s1))
        # the planes of each --pallas-fft route, at its tier
        for variant, od, tol, prec in (
                ("f32", None, TOL_FFT_ROUTE, ROUTE_TIER["fft"]),
                ("bf16", torch.bfloat16, TOL_FFT_ROUTE_BF16,
                 ROUTE_TIER["fft-bf16"])):
            planes = fk.rfft2_mixed(x, precision=prec, out_dtype=od)

            def kern(planes=planes):
                return wk.anchor_windows(planes, taps, n, n, h2, h2, s1,
                                         mixed=True)

            def plain(planes=planes):
                return wk.anchor_windows_plain(planes, taps, n, n, h2, h2,
                                               s1, mixed=True)
            vs = rel_err(_flat(kern()), natural)
            gather_ms = device_ms(
                lambda planes=planes: fk.gather_natural(planes, n, n))
            label = (f"K4 anchor_windows mixed {variant} planes ({prec}) "
                     f"{tag} D={d} taps {nk2}x{nk2}")
            rows[(frames, variant)] = measure(
                label, windows_repeated(kern, label), _flat(plain()), kern,
                plain, k4_bound(batch, d, n, nk2, od is not None),
                TOL_WINDOWS, library=None, names=K4_GRIDS,
                extra=f"; vs K4 on cuFFT's spectra {vs:.3e} (tol {tol:g}); "
                f"the gather to natural order {gather_ms:.4f} ms; three runs "
                "bit for bit" + window_plan_text(True, x, n, d, d, h2))
            rows[(frames, variant)]["gather_ms"] = gather_ms
            check(vs <= tol, f"K4 mixed {variant} {tag} vs natural: {vs:.3e}")
        T = {pw: fft_corr.corr_precompute_fused(x, *w, pallas_windows=pw)
             for pw in (None, "fft", "fft-bf16")}
        for pw, tol in (("fft", TOL_FFT_ROUTE),
                        ("fft-bf16", TOL_FFT_ROUTE_BF16)):
            worst = max((rel_err(T[pw][k], T[None][k]), k) for k in T[None])
            check(worst[0] <= tol, f"fused precompute {pw} {tag}: {worst}")
            print(f"fused precompute {pw!r} ({ROUTE_TIER[pw]} tier) {tag} "
                  "vs the default route: "
                  f"largest rel {worst[0]:.3e} ({worst[1]}; tol {tol:g})",
                  flush=True)
        host = {}
        for pw in (None, "fft", "fft-bf16", "fft-bf16", "fft", None):
            host.setdefault(pw, []).append(_host_ms(
                lambda pw=pw: fft_corr.corr_precompute_fused(
                    x, *w, pallas_windows=pw), 20))
        dev = {pw: device_ms(lambda pw=pw: fft_corr.corr_precompute_fused(
            x, *w, pallas_windows=pw)) for pw in host}
        print(f"fused precompute {tag}, host / device ms (host: the faster "
              "of two turns): " + "; ".join(
                  (f"{pw} ({ROUTE_TIER[pw]})" if pw else
                   "default (cuFFT, K4)")
                  + f" {min(host[pw]):.4f} / {dev[pw]:.4f}" for pw in host),
              flush=True)
    return rows


def _host_ms(fn, reps: int) -> float:
    """Host ms per call of ``fn`` in a synchronised loop, after one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _alternate(label: str, calls: dict, rounds: int, reps: int,
               per_call: int) -> None:
    """Host ms of each named call, the calls taken in turns for ``rounds``
    rounds (the order reversed every other round); prints every reading,
    the medians and ``per_call`` units (inner iterations) per second."""
    got = {name: [] for name in calls}
    for k in range(rounds):
        for name in (list(calls) if k % 2 == 0 else list(calls)[::-1]):
            got[name].append(_host_ms(calls[name], reps))
    for name, ms in got.items():
        med = float(np.median(ms))
        print(f"{label}, {name}: host ms {[round(v, 4) for v in ms]}, median "
              f"{med:.4f} ms, {per_call / med * 1e3:.0f} inner iterations/s",
              flush=True)


def phase_bursts(gen: torch.Generator) -> None:
    """Where a burst's time goes at 256^2 batch 8 (pair 0's input of the
    default net, 128^2): one fused 100-iteration burst and one 16-frame
    stream flush through K4, and the flush with ``--pallas-fft``'s route
    (host, device, busy share, top kernels and host operations); both again
    in turns with the windows on their plain version
    (``pallas_windows=False``; the flush with the "fft" route too), and the
    iteration loop alone; the
    fused precompute alone, K4 against the plain version, at every
    WINDOW_SIZES; and the burst's TF32 guard."""
    from spectralae_torch.train import fft_corr, streaming
    params, spec = _net(256)
    iters = 100
    frames = torch.rand(8, 3, 256, 256, device="cuda", generator=gen) * 255
    x = streaming._pair_input(params, frames, spec.scales, 0)
    enc, dec = params.pair(0)
    w = (enc.c, dec.c, enc.b, dec.b)
    xs = torch.rand(16, 8, 3, 256, 256, device="cuda", generator=gen) * 255

    def burst(pw):
        return lambda: fft_corr.burst_corr(x, None, None, *w, iters=iters,
                                           pallas_windows=pw)

    def flush(pw):
        return lambda: streaming.fft_stream_pair(
            xs, params, spec.scales, 0, iters=iters, pallas_windows=pw)
    _breakdown(f"fused burst {tuple(x.shape)} {iters} iterations, K4",
               burst(None), reps=5)
    _breakdown(f"stream flush 16 frames 256x256 b8 pair 0, {iters} "
               "iterations, K4", flush(None), reps=1)
    _breakdown(f"stream flush 16 frames 256x256 b8 pair 0, {iters} "
               "iterations, --pallas-fft (B5 at the high tier and K4 in "
               "mixed order)", flush("fft"), reps=1)
    # host time varies by tens of percent between calls on this machine:
    # compare the routes only in turns
    _alternate(f"fused burst {iters} iterations", {
        "K4": burst(None), "plain windows": burst(False)}, 4, 5, iters)
    _alternate(f"stream flush 16 frames x {iters} iterations", {
        "K4": flush(None), "plain windows": flush(False),
        "--pallas-fft (high)": flush("fft"),
        "--pallas-fft --bf16 (default)": flush("fft-bf16")}, 2, 1,
        16 * iters)
    T = fft_corr.corr_precompute_fused(x, *w)
    _alternate(f"iteration loop alone ({iters} iterations)", {
        "corr_iterate": lambda: fft_corr.corr_iterate(
            T, *w, nx=x.shape[-2], ny=x.shape[-1], iters=iters)}, 2, 5,
        iters)
    for size, batch in WINDOW_SIZES:
        n = size // 2
        xn = torch.rand(batch, 3, n, n, device="cuda", generator=gen) * 255
        got = {}
        for pw in (None, False, False, None):
            got.setdefault(pw, []).append(_host_ms(
                lambda pw=pw: fft_corr.corr_precompute_fused(
                    xn, *w, pallas_windows=pw), 20))
        dev = {pw: device_ms(lambda pw=pw: fft_corr.corr_precompute_fused(
            xn, *w, pallas_windows=pw)) for pw in (None, False)}
        print(f"fused precompute {n}x{n} b{batch} ({size}^2 frames): K4 "
              f"host {min(got[None]):.4f} ms device {dev[None]:.4f} ms; "
              f"plain windows host {min(got[False]):.4f} ms device "
              f"{dev[False]:.4f} ms (host: the faster of two turns)",
              flush=True)
    # the entry points run in IEEE float32 whatever the caller set
    out = {}
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        r = fft_corr.burst_corr(x, None, None, *w, iters=20)
        check(torch.backends.cuda.matmul.allow_tf32 is tf32,
              "burst_corr did not restore the caller's TF32 setting")
        out[tf32] = _flat((r.c, r.f, r.b, r.p, r.mses))
    torch.backends.cuda.matmul.allow_tf32 = False
    check(torch.equal(out[True], out[False]),
          "burst_corr's result depends on the caller's TF32 setting")
    print("burst_corr with TF32 on in the caller: bit-identical to TF32 off",
          flush=True)


# ------------------------------------------ 3d: the omega-space bursts

OMEGA_ROWS = (  # counter key, kernel, the Pallas body it replaces
    ("k5", "grad_project", "spectralae/train/fft_pallas.py:90"),
    ("k6", "respectra_conv", "spectralae/train/fft_pallas.py:170"),
    ("k7", "fused_step", "spectralae/train/fft_pallas.py:413"),
    ("k8", "itergrid", "spectralae/train/fft_iter.py:59"))
OMEGA_GRIDS = ("::tc_sweep_kernel", "::tc_itergrid_kernel")
# grids in one launch: K5, K6 and K7 (the tensor-core sweep) sum the tiles'
# partials inside their one grid, K8 between grid barriers
OMEGA_GRIDS_PER_LAUNCH = {"k5": 1, "k6": 1, "k7": 1, "k8": 1}
# the least share of a K5-K8 call's device time its own grids may read:
# beside them the call runs only a small cat or empty (the tiles are
# cached), so a profile that reads less dropped their records
OMEGA_SHARE = 0.8
# each kernel's outputs, held one by one against the plain version's (their
# scales differ by up to 1e17: the MSE sums beside O, g and the biases')
OMEGA_OUTPUTS = {"k5": ("g", "db", "dp"), "k6": ("O", "mse"),
                 "k7": ("O", "mse", "g", "db", "dp"),
                 "k8": ("cf", "b", "p", "mcf", "mb", "mp", "mses")}
# each path: the engine, and its launches per burst of `iters` iterations
OMEGA_ENGINES = {
    "omega_pallas": ("fft_pallas", "fft_burst_pallas",
                     lambda n: {"k5": n, "k6": n}),
    "omega_fused": ("fft_pallas", "fft_burst_pallas_fused",
                    lambda n: {"k5": 1, "k7": n}),
    "omega_itergrid": ("fft_iter", "fft_burst_itergrid",
                       lambda n: {"k8": 1})}
OMEGA_ITERS = 100
# K5-K7 against their plain versions: the same float32 products summed in
# another order (the projection over up to 33,024 bins); bf16 operands: a
# sum that lands across a bf16 rounding boundary in one version and not in
# the other moves that operand by 2^-9; K8's weights after STREAM_CMP_ITERS
# iterations through the inertia's g/max(|g|, 10), the bound of the stream
# comparison
TOL_OMEGA, TOL_OMEGA_BF16 = 1e-5, 2e-3


def omega_tols(key: str, bf16: bool) -> dict:
    """Each output's tolerance of K5-K8 against its plain version:
    TOL_OMEGA (K8's weights: TOL_STREAM_W), TOL_OMEGA_BF16 with bf16
    operands; K8's momenta and MSEs at least the stream comparison's."""
    t = (TOL_OMEGA_BF16 if bf16 else TOL_STREAM_W if key == "k8"
         else TOL_OMEGA)
    return {out: max(t, TOL_STREAM_MSE if out == "mses" else TOL_STREAM_MOM)
            if key == "k8" and out[0] == "m" else t
            for out in OMEGA_OUTPUTS[key]}


def omega_cost(key: str, nb: int, m: int, d: int, p: int, w: int,
               iters: int = 0):
    """Float32 operations and bytes of one launch of K5-K8 over ``w`` bins
    of ``nb`` frames: each rebuild of the 2·M·D kernel spectra and each
    projection of the gradient spectra is 2·2·(2MD)·P·W flops; per bin and
    frame the forward is 16·M·D, the gradient products 32·M·D, the MSE
    term 6·D; the planes, basis, weights and kernels read once, the outputs
    written once.  K8 runs ``iters`` iterations: iters+1 rebuilds (none at
    0), iters projections, iters gradient passes (on O0, then after each
    forward but the last, whose gradients feed no update), iters forwards
    and iters+1 MSEs."""
    rows, bd = 2 * m * d, nb * d
    basis = 4.0 * rows * p * w
    fwd, grad, mse = 16 * m * d, 32 * m * d, 6 * d
    small = rows * p + m + d
    inputs = 2 * p * w + w + small
    if key == "k5":
        return (2 * basis + w * (nb * grad + 2 * rows),
                4.0 * (6 * bd * w + inputs + small))
    if key == "k6":
        return (basis + w * nb * (fwd + mse),
                4.0 * (6 * bd * w + inputs + 1))
    if key == "k7":
        return (2 * basis + w * (nb * (fwd + grad + mse) + 2 * rows),
                4.0 * (6 * bd * w + inputs + small + 1))
    rebuilds = iters + 1 if iters else 0
    return ((rebuilds + iters) * basis
            + w * nb * (iters * (fwd + grad) + (iters + 1) * mse),
            4.0 * (6 * bd * w + inputs + 3 * small + iters + 1))


def omega_tc_bound(key: str, nb: int, m: int, d: int, p: int, w: int,
                   bf16: bool, iters: int = 0) -> tuple[float, str]:
    """The bound of K5-K8 as they now run: the larger of the bytes
    (omega_cost's, the basis at 2 bytes an element with bf16 operands)
    over the memory rate and the operations over their
    rates, the per-bin float32 work at the float32 peak plus the basis
    products at the bf16 tensor-core peak, each pass of a tier's products
    counted (burst_kernels.TC_TIERS: the rebuild's and the projection's
    products of bf16 pieces): one rebuild and one projection in K5 and K7,
    one rebuild in K6, ``iters`` + 1 rebuilds (none at 0) and ``iters``
    projections in K8."""
    from spectralae_torch.ops import burst_kernels as bk
    from spectralae_torch.ops import fft_kernels as fk
    flops, nbytes = omega_cost(key, nb, m, d, p, w, iters)
    if bf16:    # the function needs the basis once, as bf16
        nbytes -= 2.0 * 2 * p * w
    basis = 4.0 * (2 * m * d) * p * w        # one pass of one product
    rebuild, project = (len(fk._PRODUCTS[t]) for t in bk.TC_TIERS[bf16])
    n_rb, n_pj = {"k6": (1, 0),
                  "k8": (iters + 1 if iters else 0, iters)}.get(key, (1, 1))
    t_tc = (n_rb * rebuild + n_pj * project) * basis / fk.BF16_TC_FLOP_PER_S \
        * 1e3
    t_ops = (flops - (n_rb + n_pj) * basis) / FP32_FLOP_PER_S * 1e3 + t_tc
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _omega_inputs(gen: torch.Generator) -> list:
    """The two burst inputs: the JAX benchmark's headline (one [3, 256,
    256] frame x 50, O0 from the forward of a one-pair default net,
    bench.py:453-483) and the stream's pair-0 input (128^2 b8 of 256^2
    frames, O0 from the pair's own forward); pair-0 kernels of the default
    net (D=3, M=10, 5x5) with biases set non-zero."""
    from spectralae_torch.core.config import Config
    from spectralae_torch.core.types import init_params, initial_spec
    from spectralae_torch.model import autoencoder as model
    from spectralae_torch.train import fft_corr, streaming
    cfg = Config(nx=256, ny=256)
    spec1 = initial_spec(cfg)
    one = init_params(torch.Generator().manual_seed(0), spec1, cfg.layer.rmax,
                      device="cuda")
    x0 = torch.randn(3, 256, 256, device="cuda", generator=gen) * 50
    with torch.no_grad():
        out0 = model.forward_fft(one, x0[None], spec1.scales)[0]
    params, spec = _net(256)
    frames = torch.rand(8, 3, 256, 256, device="cuda", generator=gen) * 255
    xs = streaming._pair_input(params, frames, spec.scales, 0)
    out = []
    for label, x, o, net in (("256x256 b1 (headline)", x0, out0, one),
                             ("128x128 b8 (stream pair 0)", xs, None,
                              params)):
        enc, dec = net.pair(0)
        w = (enc.c, dec.c,
             torch.randn(enc.c.shape[0], device="cuda", generator=gen) * 0.5,
             torch.randn(dec.c.shape[0], device="cuda", generator=gen) * 0.5)
        if o is None:
            o = fft_corr._true_forward(x, *w, True)
        out.append((label, x, o, w))
    return out


def _omega_taps13(gen: torch.Generator) -> tuple:
    """The harness's 13×13 burst input (``bench.taps13``): one [3, 256,
    256] frame, O0 from the forward of a one-pair net of 13×13 kernels (169
    taps, K5-K8's contraction over taps in six chunks of 32), pair-0
    weights from seed 0 with biases set non-zero."""
    from spectralae_torch.core.config import Config, LayerParams
    from spectralae_torch.core.types import init_params, initial_spec
    from spectralae_torch.model import autoencoder as model
    cfg = Config(nx=256, ny=256, layer=LayerParams(lk=5, ll=5))
    spec = initial_spec(cfg)
    net = init_params(torch.Generator().manual_seed(0), spec, cfg.layer.rmax,
                      device="cuda")
    x = torch.randn(3, 256, 256, device="cuda", generator=gen) * 50
    with torch.no_grad():
        out0 = model.forward_fft(net, x[None], spec.scales)[0]
    enc, dec = net.pair(0)
    w = (enc.c, dec.c,
         torch.randn(enc.c.shape[0], device="cuda", generator=gen) * 0.5,
         torch.randn(dec.c.shape[0], device="cuda", generator=gen) * 0.5)
    return "256x256 b1 13x13 (169 taps)", x, out0, w


def _omega_kernel_rows(label, x, out0, w) -> dict:
    """K5-K8 at one input against their plain versions, float32 and bf16
    operands, each also run twice more and held bit for bit and timed; K8
    at STREAM_CMP_ITERS iterations.  Returns the timed rows by (kernel,
    variant), and each kernel's largest absolute error and largest
    norm-relative error of one output over both variants."""
    from spectralae_torch.ops import burst_kernels as bk
    from spectralae_torch.train import fft_pallas as fp
    s = fp._prepare(x, x, out0, w[0], True, torch.float32)
    M, D, nk, _ = w[0].shape
    P = nk * nk
    cf, b, p = fp._stack(w[0], w[1], M * D, P), w[2], w[3]
    ops = (s.planes, s.basis, s.wv, cf, b)
    nb, W = s.nb, s.planes.shape[-1]
    zeros = [torch.zeros_like(t) for t in (cf, b, p)]
    it = STREAM_CMP_ITERS
    rows, errs, rels = {}, {}, {}
    for variant in ("f32", "bf16"):
        bf16 = variant == "bf16"
        k = dict(s.consts, mxu_bf16=bf16)
        k5 = {n: k[n] for n in ("norm", "scale", "mxu_bf16")}
        k6 = {n: k[n] for n in ("norm", "inv_m", "inv_d", "mxu_bf16")}
        k8 = dict(k, iters=it, lr_eff=0.02, alpha=0.9)
        tag = f"{label} {variant} operands, W={W}"
        calls = {
            "k5": (lambda: bk.grad_project(*ops, **k5),
                   lambda: bk.grad_project_plain(*ops, **k5)),
            "k6": (lambda: bk.respectra_conv(*ops, p, **k6),
                   lambda: bk.respectra_conv_plain(*ops, p, **k6)),
            "k7": (lambda: bk.fused_step(*ops, p, **k),
                   lambda: bk.fused_step_plain(*ops, p, **k)),
            "k8": (lambda: bk.itergrid(*ops, p, *zeros, **k8),
                   lambda: bk.itergrid_plain(*ops, p, *zeros, **k8))}
        for key, name, _ in OMEGA_ROWS:
            kern, plain = calls[key]
            tols = omega_tols(key, bf16)
            got, want = kern(), plain()
            what = f"K{key[1]} {name} {tag}" + (f", {it} iterations"
                                                if key == "k8" else "")
            held = {out: (rel_err(g_.reshape(-1), w_.reshape(-1)),
                          tols[out])   # norm-relative error, tolerance
                    for out, g_, w_ in zip(OMEGA_OUTPUTS[key], got, want)}
            print(f"{what}: " + ", ".join(f"{o} rel {e:.3e} (tol {tt:g})"
                                          for o, (e, tt) in held.items()),
                  flush=True)
            bad = [o for o, (e, tt) in held.items() if not e <= tt]
            check(not bad, f"{what} disagrees in {bad}")
            rel = max(e for e, _ in held.values())
            rels[key] = max(rels.get(key, 0.0), rel)
            got, want = _flat(got), _flat(want)
            errs[key] = max(errs.get(key, 0.0),
                            float((got - want).abs().max()))
            same = all(torch.equal(got, _flat(kern())) for _ in range(2))
            check(same, f"{what}: three runs differ")
            old = bound_ms(*omega_cost(key, nb, M, D, P, W, it))
            bound = omega_tc_bound(key, nb, M, D, P, W, bf16,
                                   it if key == "k8" else 0)
            extra = (f"; three runs bit-identical; the old bound (float32 "
                     f"basis products) {old[0]:.4f} ms ({old[1]})")
            rows[(key, variant)] = measure(
                what, got, want, kern, plain, bound,
                max(tt for _, tt in held.values()), library=None,
                names=OMEGA_GRIDS, share=OMEGA_SHARE, rel=rel, extra=extra)
    return rows, errs, rels


def _burst_vs(label, a, b, tols) -> None:
    """Weights, momentum and MSEs of two bursts (the second on any
    device), each norm-relative (MSEs: largest relative entry)."""
    errs = {"weights": rel_err(_flat((a.c, a.f, a.b, a.p)).cpu(),
                               _flat((b.c, b.f, b.b, b.p)).cpu()),
            "momentum": rel_err(_flat(a.mom).cpu(), _flat(b.mom).cpu()),
            "mses": float(((a.mses.double().cpu() - b.mses.double().cpu())
                           .abs() / b.mses.double().cpu().abs()).max())}
    print(f"{label}: " + ", ".join(f"{n} {e:.3e} (tol {tols[n]:g})"
                                   for n, e in errs.items()), flush=True)
    for n, e in errs.items():
        check(e <= tols[n], f"{label}: {n} {e:.3e} > {tols[n]:g}")


def phase_omega(gen: torch.Generator) -> tuple[dict, ...]:
    """3d: K5-K8 against their plain versions at both inputs and with
    13×13 kernels at the headline's frame size (:func:`_omega_taps13`),
    then each engine at both inputs: launches per burst (no plain version may run on the card), a
    STREAM_CMP_ITERS burst against the CPU port and the card's ω-space
    burst (``fft_burst(impl="dft")``, batched: ``fft_burst_dp``'s ω body),
    an OMEGA_ITERS burst within the map's spread of the card's ω-space
    burst, B9 run twice bit for bit, and host / device ms per OMEGA_ITERS
    burst beside ``fft_burst`` and ``burst_corr``.  Returns the kernel
    rows, each kernel's largest absolute and norm-relative errors, the
    launches of each engine's path (one OMEGA_ITERS burst at the headline
    input) and the engine times."""
    from spectralae_torch.ops import burst_kernels as bk
    from spectralae_torch.train import fft, fft_corr, fft_dp
    from spectralae_torch.train import fft_iter, fft_pallas
    mods = {"fft_pallas": fft_pallas, "fft_iter": fft_iter}
    t0 = time.perf_counter()
    inputs = _omega_inputs(gen)
    rows, errs, rels = {}, {}, {}
    for label, x, out0, w in inputs + [_omega_taps13(gen)]:
        timed, e, r = _omega_kernel_rows(label, x, out0, w)
        rows.update({(label,) + k: v for k, v in timed.items()})
        errs = {k: max(errs.get(k, 0.0), v) for k, v in e.items()}
        rels = {k: max(rels.get(k, 0.0), v) for k, v in r.items()}
    print(f"phase 3d: kernel rows {time.perf_counter() - t0:.1f} s",
          flush=True)
    fallbacks = []
    plains = ("grad_project_plain", "respectra_conv_plain",
              "fused_step_plain", "itergrid_plain")
    real = {n: getattr(bk, n) for n in plains}

    def guarded(name):
        def guard(planes, *a, **kw):
            if planes.is_cuda:
                fallbacks.append(name)
            return real[name](planes, *a, **kw)
        return guard
    by_path, timing = {}, {}
    for n in plains:
        setattr(bk, n, guarded(n))
    try:
        for label, x, out0, w in inputs:
            head = label.startswith("256")
            cpu = [t.cpu() for t in (x, out0) + w]

            def ref(iters):
                a = (x, out0) + w
                if a[0].dim() == 3:
                    return fft.fft_burst(a[0], a[0], a[1], *a[2:],
                                         iters=iters, impl="dft")
                return fft_dp.fft_burst_dp(a[0], a[0], a[1], *a[2:],
                                           iters=iters, use_pallas=False)
            cmp_tols = {"weights": TOL_STREAM_W, "momentum": TOL_STREAM_MOM,
                        "mses": TOL_STREAM_MSE}
            dft10, dft100 = ref(STREAM_CMP_ITERS), ref(OMEGA_ITERS)
            calls = {}
            for path, (mod, fn_name, per) in OMEGA_ENGINES.items():
                fn = getattr(mods[mod], fn_name)

                def run(iters, a=(x, out0) + w, fn=fn):
                    return fn(a[0], a[0], a[1], *a[2:], iters=iters)
                for iters in (STREAM_CMP_ITERS, OMEGA_ITERS):
                    reset_counts()
                    r = run(iters)
                    torch.cuda.synchronize()
                    got = counts()
                    want = dict.fromkeys(got, 0)
                    want.update(per(iters))
                    check(got == want, f"{path} {label} {iters} iterations: "
                          f"launches {got}, expected {want}")
                    if head and iters == OMEGA_ITERS:
                        by_path[path] = got
                    check(bool(torch.isfinite(r.mses).all()),
                          f"{path} {label}: non-finite mse")
                    if iters == STREAM_CMP_ITERS:
                        _burst_vs(f"{path} {label} {iters} iterations, card "
                                  "vs CPU port", r, run(iters, cpu), cmp_tols)
                        _burst_vs(f"{path} {label} {iters} iterations, card "
                                  "vs the card's fft_burst(impl='dft')", r,
                                  dft10, cmp_tols)
                w_err = rel_err(_flat((r.c, r.f, r.b, r.p)),
                                _flat((dft100.c, dft100.f, dft100.b,
                                       dft100.p)))
                ratio = float(r.mses[-1] / dft100.mses[-1])
                print(f"{path} {label} {OMEGA_ITERS} iterations: mse "
                      f"{float(r.mses[0]):.6g} -> {float(r.mses[-1]):.6g}; "
                      f"vs the card's fft_burst(impl='dft') weights "
                      f"{w_err:.3e} (tol "
                      f"{TOL_LONG_W:g}), last mse ratio {ratio:.4f} (within "
                      f"a factor {TOL_LONG_MSE_FACTOR:g})", flush=True)
                check(w_err <= TOL_LONG_W and 1 / TOL_LONG_MSE_FACTOR <= ratio
                      <= TOL_LONG_MSE_FACTOR, f"{path} {label}: long burst")
                if path == "omega_itergrid":
                    again = run(OMEGA_ITERS)
                    same = all(torch.equal(getattr(r, n), getattr(again, n))
                               for n in ("c", "f", "b", "p", "mses")) and \
                        all(torch.equal(a, b) for a, b in zip(r.mom,
                                                              again.mom))
                    print(f"omega_itergrid {label}: two {OMEGA_ITERS}-"
                          f"iteration runs bit-identical: {same}", flush=True)
                    check(same, "omega_itergrid runs differ")
                calls[path] = (lambda run=run: run(OMEGA_ITERS), (
                    sum(per(OMEGA_ITERS).values()),
                    sum(n * OMEGA_GRIDS_PER_LAUNCH[k]
                        for k, n in per(OMEGA_ITERS).items())))
            calls["fft_burst(impl='dft')"] = (lambda: ref(OMEGA_ITERS), None)
            calls["burst_corr"] = (lambda: fft_corr.burst_corr(
                x, x, out0, *w, iters=OMEGA_ITERS), None)
            for name, (fn, launches) in calls.items():
                host = _host_ms(fn, 2)
                # the plain omega-space burst makes tens of thousands of
                # device operations a call: a profile of two calls
                ncall = 2 if name.startswith("fft_burst") else REPS
                ops = device_ops(fn, ncall)
                dev = sum(ms * k for _, ms, k, _ in ops)
                held = sum(c for key, _, _, c in ops
                           if any(g in key for g in OMEGA_GRIDS))
                per_it = None
                if launches is not None:
                    per_it = launches[0] / OMEGA_ITERS
                # events around the calls: the device time of a burst that
                # waits on the device (B9), the host's pace for the others
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(2):
                    fn()
                stop.record()
                torch.cuda.synchronize()
                ev = start.elapsed_time(stop) / 2
                per_op = sum(k for _, _, k, _ in ops) / OMEGA_ITERS
                timing[(label, name)] = {"host_ms": host, "device_ms": dev,
                                         "events_ms": ev, "busy": dev / host,
                                         "launches_per_iteration": per_it,
                                         "device_ops_per_iteration": per_op}
                print(f"{OMEGA_ITERS}-iteration burst {label}, {name}: host "
                      f"{host:.4f} ms, device {dev:.4f} ms over {ncall} calls "
                      f"(busy {dev / host:.1%}), events {ev:.4f} ms, device "
                      f"operations per iteration {per_op:.2f}" + (
                          "" if per_it is None else
                          f", hand-written kernel launches per iteration "
                          f"{per_it:g} ({launches[1] / OMEGA_ITERS:g} grids; "
                          f"the profile held {held} of their "
                          f"{launches[1] * ncall} records)"), flush=True)
        check(not fallbacks, f"plain versions ran on the card: {fallbacks}")
    finally:
        for n in plains:
            setattr(bk, n, real[n])
    print(f"phase 3d: {time.perf_counter() - t0:.1f} s in all", flush=True)
    return rows, errs, rels, by_path, timing


def phase_stream_training(tmp: Path) -> tuple[dict, dict, dict]:
    """``train --mode stream`` (with and without ``--pallas-fft``) and
    ``--mode burst`` through the CLI on the card (see the module
    docstring).  Returns the launches of the stream, stream_fft and burst
    paths."""
    from spectralae_torch.io import checkpoint as ckpt
    from spectralae_torch.ops import fft_kernels as fk
    from spectralae_torch.ops import spectral
    from spectralae_torch.ops import window_kernels as wk
    from spectralae_torch.train import fft_corr
    fallbacks = []
    # no plain version of a kernel may run on the card
    plains = [(wk, "anchor_windows_plain"), (fft_corr, "anchor_windows_plain"),
              (spectral, "resize_plain")]
    plains += [(fk, name) for name in (
        "rfft_y_mixed_plain", "fft_x_mixed_plain", "_fft_yc_plain",
        "_bfly_lanes_plain", "_bfly_rows_plain")]
    common = ["train", "--nx", "256", "--layers", "3", "--batch", "8",
              "--seed", "0", "--log-every", "1"]
    stream = common + ["--mode", "stream", "--stream-k", "16"]
    fft = stream + ["--pallas-fft"]
    ck_dir, ck_fft = tmp / "stream", tmp / "stream_fft"
    resume = STREAM_STEPS + STREAM_RESUME
    fft_resume = STREAM_FFT_STEPS + STREAM_FFT_RESUME
    one_fft = {"k4": 1, "b5a": 1, "b5b": 1, "rs": 1}
    # label, argv, first step, frames, launches per frame (the resize
    # pools each trained pair's input: pair n_l's n_l + 1 times, after K1
    # at the n_l stages before it), what to check:
    # "first" (the mse falls, the checkpoint holds the last step),
    # "resumed" (starts far below its first run), "falls"
    stream_runs = (
        ("stream", stream + ["--steps", str(STREAM_STEPS), "--ckpt",
                             str(ck_dir)], 0, STREAM_STEPS,
         {"k4": 1, "rs": 1}, "first"),
        ("stream resumed", stream + ["--steps", str(resume), "--resume",
                                     str(ck_dir), "--ckpt", str(ck_dir)],
         STREAM_STEPS, STREAM_RESUME, {"k4": 1, "rs": 1}, "resumed"),
        ("stream --bf16", stream + ["--steps", "16", "--bf16"], 0, 16,
         {"k4": 1, "rs": 1}, "falls"),
        ("stream --train-pair all --pair-sweep frame",
         stream + ["--steps", "4", "--stream-k", "4", "--train-pair", "all",
                   "--pair-sweep", "frame"], 0, 4,
         {"k4": 3, "k1": 3, "rs": 6}, None))
    fft_runs = (
        ("stream --pallas-fft", fft + ["--steps", str(STREAM_FFT_STEPS),
                                       "--ckpt", str(ck_fft)], 0,
         STREAM_FFT_STEPS, one_fft, "first"),
        ("stream --pallas-fft resumed",
         fft + ["--steps", str(fft_resume), "--resume", str(ck_fft),
                "--ckpt", str(ck_fft)], STREAM_FFT_STEPS, STREAM_FFT_RESUME,
         one_fft, "resumed"),
        ("stream --pallas-fft --bf16", fft + ["--steps", "16", "--bf16"], 0,
         16, one_fft, "falls"),
        ("stream --pallas-fft --train-pair all --pair-sweep frame",
         fft + ["--steps", "4", "--stream-k", "4", "--train-pair", "all",
                "--pair-sweep", "frame"], 0, 4,
         {"k4": 3, "k1": 3, "b5a": 3, "b5b": 3, "rs": 6}, None))

    def drive(runs) -> dict:
        reset_counts()
        loss0 = None
        for label, argv, first, frames, per_frame, kind in runs:
            before = counts()
            t0 = time.perf_counter()
            recs = _cli_records(argv)
            wall = time.perf_counter() - t0
            got = grown(before)
            want = {k: per_frame.get(k, 0) * frames for k in got}
            check(got == want, f"{label}: launches {got}, expected {want}")
            steps = sorted({r["step"] for r in recs})
            check(steps == list(range(first, first + frames)),
                  f"{label}: logged steps {steps}")
            mse0 = [r["mse0"] for r in recs if r["pair"] == 0]
            check(all(math.isfinite(r["mseN"]) for r in recs),
                  f"{label}: non-finite mse")
            # one burst of 100 iterations per K4 launch
            print(f"train {label} 256x256 b8 steps {first}-"
                  f"{first + frames - 1}: pair-0 entry mse {mse0[0]:.6g} -> "
                  f"{mse0[-1]:.6g}; launches {got}; {wall:.2f} s CLI wall, "
                  f"{100 * got['k4'] / wall:.0f} inner iterations/s",
                  flush=True)
            if kind in ("first", "falls"):
                check(mse0[-1] < mse0[0], f"{label}: the mse did not fall")
            if kind == "first":
                loss0 = mse0[0]
                ck = Path(argv[argv.index("--ckpt") + 1])
                check(ckpt.load(ck)[3]["step"] == first + frames,
                      f"{label}: checkpoint step")
            elif kind == "resumed":
                check(mse0[0] < 0.1 * loss0,
                      f"{label}: first entry mse {mse0[0]:.6g} is not far "
                      f"below the first run's {loss0:.6g}")
        return counts()

    with guard_plains(plains, fallbacks):
        stream_launches = drive(stream_runs)
        fft_launches = drive(fft_runs)
        check(not fallbacks, f"plain versions ran on the card: {fallbacks}")
        reset_counts()
        before = counts()
        recs = _cli_records(common + ["--mode", "burst", "--steps", "3"])
        got = grown(before)
        want = dict.fromkeys(got, 0)
        want.update(k1=18, k3=6, rs=18)
        check(got == want, f"burst: launches {got}, expected {want}")
        check([r["step"] for r in recs] == [0, 1, 2]
              and all(math.isfinite(r["mseN"]) for r in recs)
              and recs[-1]["mse0"] < recs[0]["mse0"],
              f"burst: {[(r['step'], r['mse0'], r['mseN']) for r in recs]}")
        print(f"train burst 256x256 b8 steps 0-2: entry mse "
              f"{recs[0]['mse0']:.6g} -> {recs[-1]['mse0']:.6g}; launches "
              f"{got} (K1 and the resize 6 per step through forward_fft, "
              "K3 2 per burst precompute)", flush=True)
        burst_launches = counts()
        try:
            _cli_records(common + ["--mode", "burst", "--steps", "1",
                                   "--pallas-fft"])
            refused = None
        except SystemExit as exc:
            refused = exc.code
        check(isinstance(refused, str) and "burst mode anchors" in refused,
              f"train --mode burst --pallas-fft did not exit with its "
              f"reason: {refused!r}")
        print(f"train --mode burst --pallas-fft exits non-zero: {refused}",
              flush=True)
        return stream_launches, fft_launches, burst_launches


def phase_stream_vs_cpu() -> None:
    """A 3-frame stream of pair 0 on the card and on the CPU, from the same
    weights and frames: at STREAM_CMP_ITERS iterations a frame the weights,
    momentum and MSE trajectories agree; at STREAM_LONG_ITERS the weights
    and each frame's last MSE stay within the map's spread (printed beside:
    the CPU's own distance under a 1e-7 relative change of the frames)."""
    from spectralae_torch.core.types import AEParams
    from spectralae_torch.data import pipeline
    from spectralae_torch.train.streaming import stream_bursts_pair
    params, spec = _net(256)
    frames = np.stack([pipeline.frame_to_tensor(f) for f in itertools.islice(
        pipeline.synthetic_frames(256, 256, seed=7), 24)])
    xs = torch.from_numpy(frames).reshape(3, 8, 3, 256, 256)
    on = {dev: AEParams.from_leaves([t.to(dev) for t in params.leaves()])
          for dev in ("cuda", "cpu")}

    def run(dev, iters, frames=xs, pw=None):
        r = stream_bursts_pair(frames.to(dev), on[dev], spec.scales, 0,
                               iters=iters, pallas_windows=pw)
        return r._replace(c=r.c.cpu(), f=r.f.cpu(), b=r.b.cpu(),
                          p=r.p.cpu(), mses=r.mses.cpu(),
                          mom=tuple(m.cpu() for m in r.mom))

    def weights(r):
        return _flat((r.c, r.f, r.b, r.p))

    def last_ratio(r, ref):
        return (r.mses[:, -1].double() / ref.mses[:, -1].double()).tolist()
    # the default route (cuFFT and K4) and the --pallas-fft one (the
    # four-step rfft2's kernels and K4 in mixed order; on the CPU their
    # plain versions)
    for pw in (None, "fft"):
        a = run("cuda", STREAM_CMP_ITERS, pw=pw)
        b = run("cpu", STREAM_CMP_ITERS, pw=pw)
        errs = {"weights": (rel_err(weights(a), weights(b)), TOL_STREAM_W),
                "momentum": (rel_err(_flat(a.mom), _flat(b.mom)),
                             TOL_STREAM_MOM),
                "mses": (float(((a.mses.double() - b.mses.double()).abs()
                                / b.mses.double().abs()).max()),
                         TOL_STREAM_MSE)}
        print(f"stream 3 frames x {STREAM_CMP_ITERS} iterations, 256x256 b8 "
              f"pair 0, pallas_windows={pw!r}, card vs CPU port: "
              + ", ".join(f"{k} {e:.3e} (tol {t:g})"
                          for k, (e, t) in errs.items()), flush=True)
        for k, (e, t) in errs.items():
            check(e <= t, f"stream {pw!r} card vs CPU: {k} {e:.3e} > {t:g}")
    a, b = run("cuda", STREAM_LONG_ITERS), run("cpu", STREAM_LONG_ITERS)
    moved = run("cpu", STREAM_LONG_ITERS, xs * (1 + 1e-7))
    w_err = rel_err(weights(a), weights(b))
    ratio = last_ratio(a, b)
    check(bool(torch.isfinite(a.mses).all()), "long stream: non-finite mse")
    print(f"stream 3 frames x {STREAM_LONG_ITERS} iterations, card vs CPU "
          f"port: weights {w_err:.3e} (tol {TOL_LONG_W:g}), last mse ratio "
          f"per frame {[round(r, 4) for r in ratio]} (within a factor "
          f"{TOL_LONG_MSE_FACTOR:g}); the CPU against itself on frames x "
          f"(1+1e-7): weights {rel_err(weights(moved), weights(b)):.3e}, "
          f"last mse ratio {[round(r, 4) for r in last_ratio(moved, b)]}",
          flush=True)
    check(w_err <= TOL_LONG_W, f"long stream card vs CPU: weights "
          f"{w_err:.3e} > {TOL_LONG_W:g}")
    check(all(1 / TOL_LONG_MSE_FACTOR <= r <= TOL_LONG_MSE_FACTOR
              for r in ratio), f"long stream card vs CPU: last mse ratios "
          f"{ratio} beyond a factor {TOL_LONG_MSE_FACTOR:g}")


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def op_nodes(path: Path) -> dict:
    """The kernels' operator nodes in a ``.pt2`` artifact's graph, by
    kernel key: each call of the program launches each kernel that many
    times."""
    manifest = json.loads((path / "manifest.json").read_text())
    program = torch.export.load(path / f"{manifest['what']}.pt2")
    names = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    return {"k1": names.count("spectralae_torch.cmul_contract.default"),
            "k2": names.count("spectralae_torch.conv_valid.default"),
            "rs": names.count("spectralae_torch.spectral_resize.default")}


def _frames256(seed: int, batch: int) -> np.ndarray:
    from spectralae_torch.data import pipeline
    return np.stack([pipeline.frame_to_tensor(f) for f in itertools.islice(
        pipeline.synthetic_frames(256, 256, seed=seed), batch)])


def _launched_as_graph(label: str, before: dict, nodes: dict) -> None:
    """The launches since ``before`` are exactly one per operator node."""
    g = grown(before)
    check(all(g[k] == n for k, n in nodes.items()),
          f"{label}: launched K1 {g['k1']}x, K2 {g['k2']}x and the resize "
          f"{g['rs']}x, its graph holds {nodes['k1']}, {nodes['k2']} and "
          f"{nodes['rs']} operator nodes")


def _opchecks(gen: torch.Generator) -> None:
    """``torch.library.opcheck`` of both operators on CUDA tensors at the
    256^2 b8 stage-0 shapes: K1 with complex64 and bf16 operands (the
    transposed kernel spectra, the bias), K2 at its 5x5 taps."""
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import spectral_kernels as sk
    n, d, m = stage_shapes(256, 3)[0]
    w = n * (n // 2 + 1)

    def cplx(*shape):
        return torch.complex(
            torch.randn(shape, device="cuda", generator=gen),
            torch.randn(shape, device="cuda", generator=gen))
    p, C = cplx(8, d, w), cplx(m, d, w)
    bias = torch.randn(m, device="cuda", generator=gen)
    cases = {
        "K1 complex64": (sk.cmul_contract_op, (
            p, C.transpose(0, 1), 1.0 / m, False, bias, float(n * n))),
        "K1 complex64 conj_q": (sk.cmul_contract_op, (
            p, C.transpose(0, 1), 1.0 / m, True, None, 0.0)),
        "K1 bf16": (sk.cmul_contract_op, (
            sk.bf16_planes(p, 1.0 / m), sk.bf16_planes(C).transpose(0, 1),
            1.0, False, bias, float(n * n))),
        "K2 float32": (ck.conv_valid_op, (
            torch.randn(8, d, n + 4, n + 4, device="cuda", generator=gen),
            torch.randn(m, d, 5, 5, device="cuda", generator=gen)))}
    for label, (op, args) in cases.items():
        res = torch.library.opcheck(op, args)
        check(set(res.values()) == {"SUCCESS"}, f"opcheck {label}: {res}")
    print(f"opcheck on the card at 256x256 b8 stage 0 ({n}^2, D={d}, "
          f"M={m}): " + ", ".join(cases) + " — schema, autograd "
          "registration, fake tensor, aot dispatch: all pass", flush=True)


def _doctor() -> None:
    """``doctor`` through the CLI: the card's name, the kernel build and
    one launch of K1 held against its plain version."""
    from spectralae_torch.cli.main import main as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(["doctor"])
    info = json.loads(buf.getvalue())
    name = torch.cuda.get_device_name(0)
    check(info.get("device") == name and info.get("nvidia_smi")
          and info["nvidia_smi"][0]["name"] == name,
          f"doctor: card {info.get('device')}, nvidia-smi "
          f"{info.get('nvidia_smi')}, expected {name}")
    check("path" in info["kernel_build"],
          f"doctor: kernel build {info['kernel_build']}")
    check(info.get("device_check", {}).get("ok") is True,
          f"doctor: device check {info.get('device_check')}")
    print(f"doctor: {info['device']} ({info['nvidia_smi'][0]['power_limit']}"
          f"), torch {info['torch']} cuda {info['cuda_runtime']}, build "
          f"{Path(info['kernel_build']['path']).name}, device check "
          f"{info['device_check']}", flush=True)


def _pt2_vs_eager(tmp: Path) -> None:
    """Host and device ms of one call of the ``.pt2`` forward (a
    symbolic-batch artifact traced on the card, through ServingModel)
    beside the eager forward (what format 1 served: the model's Python
    under inference mode, float32 matmuls), at 256^2 b8 and 1024^2 b4 in
    both domains, the two taken in turns (eager, pt2, pt2, eager)."""
    from spectralae_torch.io.export import ServingModel, export_model
    from spectralae_torch.model import autoencoder as model
    from spectralae_torch.ops.dft import ieee_f32
    for nx, batch in ((256, 8), (1024, 4)):
        params, spec = _net(nx)
        x = torch.rand(batch, 3, nx, nx, device="cuda") * 255
        for domain in ("fft", "coord"):
            art = export_model(params, spec, tmp / f"pt2_{domain}_{nx}",
                               domain=domain)
            served = ServingModel.load(art, device="cuda")
            if domain == "fft":
                def fwd():
                    return model.forward_fft(params, x, spec.scales)
            else:
                def fwd():
                    return model.forward_coord(params, x, spec.scales,
                                               tap_mode="ref_gpu")[-1]

            def eager():
                with torch.inference_mode(), ieee_f32():
                    return fwd()

            def pt2():
                return served(x)
            err = rel_err(pt2(), eager())
            check(err <= TOL_TRACE, f"pt2 {domain} {nx}: rel {err:.3e} "
                  "against the eager forward on the card")
            host = {"eager": [], "pt2": []}
            for name in ("eager", "pt2", "pt2", "eager"):
                host[name].append(_host_ms(pt2 if name == "pt2" else eager,
                                           REPS))
            # retaken where a profile held no record of the call
            dev = {name: _checked_ms(device_ms(fn), fn, cuda_ms(fn))
                   for name, fn in (("eager", eager), ("pt2", pt2))}
            h = {k: sum(v) / len(v) for k, v in host.items()}
            print(f"pt2 vs eager forward {domain} {nx}x{nx} b{batch}: host "
                  f"pt2 {h['pt2']:.4f} ms eager {h['eager']:.4f} ms "
                  f"(pt2/eager {h['pt2'] / h['eager']:.3f}; readings "
                  f"pt2 {[round(v, 4) for v in host['pt2']]} eager "
                  f"{[round(v, 4) for v in host['eager']]}), device pt2 "
                  f"{dev['pt2'][0]:.4f} ms ({dev['pt2'][1]}) eager "
                  f"{dev['eager'][0]:.4f} ms ({dev['eager'][1]}); rel "
                  f"{err:.3e} (tol {TOL_TRACE:g})", flush=True)


def _serve_domain(tmp: Path, domain: str) -> None:
    """Export through the CLI (the default 3-pair net at 256^2, --what both,
    loadable on cuda and cpu) with --batch 8 and with a symbolic batch;
    ``serve`` each; then each artifact behind an InferenceServer, three
    8-frame requests, and the symbolic one called at SERVE_BATCHES: every
    response held against the same artifact on the CPU, every call
    launching each kernel once per operator node."""
    from spectralae_torch.cli.main import main as cli
    from spectralae_torch.io.export import ServingModel
    from spectralae_torch.io.server import InferenceServer
    tol = TOL_FFT if domain == "fft" else TOL_COORD
    kernel = "k1" if domain == "fft" else "k2"
    arts = {"symbolic": tmp / domain, "batch 8": tmp / f"{domain}_b8"}
    for kind, art in arts.items():
        cli(["export", "--nx", "256", "--layers", "3", "--seed", "0",
             "--out", str(art), "--what", "both", "--domain", domain,
             "--platforms", "cuda,cpu"]
            + (["--batch", "8"] if kind == "batch 8" else []))
        cli(["serve", "--model", str(art / "forward"), "--steps", "3",
             "--batch", "8", "--outdir", str(tmp / "views")])
        for what in ("forward", "encode"):
            nodes = op_nodes(art / what)
            label = f"{domain}/{what} ({kind})"
            check(nodes[kernel] >= 1, f"{label}: no {kernel.upper()} "
                  f"operator in the graph: {nodes}")
            model = ServingModel.load(art / what, device="cuda")
            on_cpu = ServingModel.load(art / what, device="cpu")
            worst = 0.0

            def held(got, frames):
                want = on_cpu(frames)
                check(got.shape == want.shape and got.dtype == np.float32,
                      f"{label}: response {got.shape} {got.dtype}, expected "
                      f"{want.shape} float32")
                check(bool(np.isfinite(got).all()),
                      f"{label}: non-finite response")
                err = rel_err(torch.from_numpy(got), torch.from_numpy(want))
                check(err <= tol, f"{label} at batch {len(frames)}: rel "
                      f"{err:.3e} > {tol:g} against the artifact on the CPU")
                return err
            srv = InferenceServer(model, port=0)
            srv.start()
            try:
                base = f"http://127.0.0.1:{srv.port}"
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=60) as r:
                    health = json.loads(r.read())
                check(health["status"] == "ok" and health["what"] == what
                      and health["domain"] == domain, f"healthz: {health}")
                for req in range(3):
                    frames = _frames256(100 + req, 8)
                    post = urllib.request.Request(
                        base + "/infer", data=_npy(frames), method="POST",
                        headers={"Content-Type":
                                 "application/octet-stream"})
                    before = counts()
                    with urllib.request.urlopen(post, timeout=120) as r:
                        got = np.load(io.BytesIO(r.read()))
                    _launched_as_graph(f"{label} request {req}", before,
                                       nodes)
                    worst = max(worst, held(got, frames))
            finally:
                srv.shutdown()
            batches = SERVE_BATCHES if kind == "symbolic" else ()
            for b in batches:
                frames = _frames256(200 + b, b)
                before = counts()
                got = model(frames)
                _launched_as_graph(f"{label} batch {b}", before, nodes)
                worst = max(worst, held(got, frames))
            print(f"served {label} {tuple(got.shape[1:])}: 3 HTTP requests "
                  f"of 8 frames" + (f", direct calls at batches {batches}"
                                    if batches else "")
                  + f"; rel vs the artifact on the CPU {worst:.3e} (tol "
                  f"{tol:g}); each call launched K1 {nodes['k1']}x, K2 "
                  f"{nodes['k2']}x (its operator nodes)", flush=True)


def _cpu_traced(tmp: Path, domain: str) -> None:
    """A forward traced on the CPU for cpu and cuda, loaded and run on the
    card: it launches the kernels once per operator node and agrees with
    the card-traced artifact (TOL_TRACE); a cpu-only artifact is refused
    on the card."""
    from spectralae_torch.cli.main import main as cli
    from spectralae_torch.io.export import ServingModel
    common = ["export", "--nx", "256", "--layers", "3", "--seed", "0",
              "--what", "forward", "--domain", domain, "--device", "cpu"]
    art = tmp / f"{domain}_cpu_traced"
    cli(common + ["--out", str(art), "--platforms", "cpu,cuda"])
    nodes = op_nodes(art)
    check(nodes["k1" if domain == "fft" else "k2"] >= 1,
          f"CPU-traced {domain}: no kernel operator in the graph: {nodes}")
    model = ServingModel.load(art, device="cuda")
    card = ServingModel.load(tmp / domain / "forward", device="cuda")
    x = torch.from_numpy(_frames256(300, 8)).cuda()
    before = counts()
    got = model(x)
    _launched_as_graph(f"CPU-traced {domain} on the card", before, nodes)
    err = rel_err(got, card(x))
    check(err <= TOL_TRACE, f"CPU-traced {domain} on the card: rel "
          f"{err:.3e} > {TOL_TRACE:g} against the card-traced artifact")
    only = tmp / f"{domain}_cpu_only"
    cli(common + ["--out", str(only), "--platforms", "cpu"])
    try:
        ServingModel.load(only, device="cuda")
    except ValueError as e:
        refused = str(e)
    else:
        raise RuntimeError(f"a cpu-only {domain} artifact loaded on cuda")
    print(f"CPU-traced {domain} forward on the card: K1 {nodes['k1']}x K2 "
          f"{nodes['k2']}x a call, rel vs the card-traced artifact "
          f"{err:.3e} (tol {TOL_TRACE:g}); a cpu-only artifact on cuda: "
          f"refused ({refused[:60]}...)", flush=True)


def phase_serving(tmp: Path, gen: torch.Generator) -> dict:
    """Phase 4: opcheck, doctor and the .pt2-vs-eager times first (their
    launches compare or time the kernels and are not counted); then, with
    the counters reset and the plain versions guarded, the serving path in
    both domains (:func:`_serve_domain`) and the CPU-traced artifacts on
    the card (:func:`_cpu_traced`).  Returns the serving path's launches."""
    t0 = time.perf_counter()
    _opchecks(gen)
    _doctor()
    _pt2_vs_eager(tmp)
    t1 = time.perf_counter()
    reset_counts()
    fallbacks = []
    with guard_plains(_k123_plains(), fallbacks):
        for domain in ("fft", "coord"):
            _serve_domain(tmp, domain)
        for domain in ("fft", "coord"):
            _cpu_traced(tmp, domain)
    check(not fallbacks, f"plain versions ran on the card: {fallbacks}")
    launched = counts()
    print(f"phase 4 (serving): {time.perf_counter() - t0:.1f} s, of which "
          f"opcheck, doctor and the pt2-vs-eager times {t1 - t0:.1f} s; "
          f"launches K1 {launched['k1']} K2 {launched['k2']}", flush=True)
    return launched


def _cli_records(argv) -> list[dict]:
    """Run the port's CLI in this process; its JSON lines, parsed."""
    from spectralae_torch.cli.main import main as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def phase_training(tmp: Path) -> tuple[dict, dict]:
    """``train`` on the card in both domains: TRAIN_STEPS steps with a
    checkpoint, then a resume of RESUME_STEPS more, which must start from
    the saved weights (its first loss far below the first run's first); the
    launch counters are reset before this phase and must grow by exactly
    one step's launches per step.  Returns the launches of the phase, and
    each kernel's launches per step in the first run of its domain."""
    from spectralae_torch.io import checkpoint as ckpt
    common = ["train", "--nx", "256", "--layers", "3", "--batch", "8",
              "--seed", "0", "--log-every", "1"]
    reset_counts()
    per_step_seen = {}
    for domain in ("fft", "coord"):
        per_step = ((K1_PER_FFT_STEP, 0, RS_PER_FFT_STEP) if domain == "fft"
                    else (0, K2_PER_COORD_STEP, 0))
        ck_dir = tmp / f"train_{domain}"
        argv = common + ["--domain", domain, "--ckpt", str(ck_dir),
                         "--ckpt-every", "10"]
        for steps, extra in ((TRAIN_STEPS, []),
                             (TRAIN_STEPS + RESUME_STEPS,
                              ["--resume", str(ck_dir)])):
            before = counts()
            t0 = time.perf_counter()
            recs = _cli_records(argv + ["--steps", str(steps)] + extra)
            wall = time.perf_counter() - t0
            g = grown(before)
            grew = (g["k1"], g["k2"], g["rs"])
            losses = [r["loss"] for r in recs]
            first = 0 if not extra else TRAIN_STEPS
            check([r["step"] for r in recs] == list(range(first, steps)),
                  f"train {domain}: logged steps {[r['step'] for r in recs]}")
            check(all(math.isfinite(v) for v in losses),
                  f"train {domain}: non-finite loss {losses}")
            n = steps - first
            check(grew == tuple(k * n for k in per_step),
                  f"train {domain}: {n} steps launched K1 {grew[0]}x, K2 "
                  f"{grew[1]}x and the resize {grew[2]}x, expected "
                  f"{per_step} a step")
            _, _, opt, extra_ck = ckpt.load(ck_dir)
            check(extra_ck["step"] == steps and opt is not None,
                  f"train {domain}: checkpoint at step {extra_ck['step']}")
            print(f"train {domain} 256x256 b8 steps {first}-{steps - 1}"
                  f"{' (resumed)' if extra else ''}: loss {losses[0]:.6g} "
                  f"-> {losses[-1]:.6g}; launches K1 +{grew[0]} K2 "
                  f"+{grew[1]} resize +{grew[2]} ({per_step} per step); "
                  f"{wall:.2f} s wall", flush=True)
            if not extra:
                check(losses[-1] < losses[0],
                      f"train {domain}: the loss did not fall: {losses}")
                loss0 = losses[0]
                kern, i = ("k1", 0) if domain == "fft" else ("k2", 1)
                per_step_seen[kern] = grew[i] / n
                if domain == "fft":
                    per_step_seen["rs"] = grew[2] / n
            else:
                check(losses[0] < 0.1 * loss0,
                      f"train {domain}: the resumed run's first loss "
                      f"{losses[0]:.6g} is not far below the first run's "
                      f"{loss0:.6g}; it did not start from the checkpoint")
    return counts(), per_step_seen


def phase_training_bf16(tmp: Path) -> tuple[dict, dict]:
    """``train --bf16`` on the card in both domains at 256^2 batch 8, the
    default net at full width, with the identity and with ``--activation
    leaky_relu`` (the coord domain's only; the fft forward is linear and
    ignores it): TRAIN_STEPS steps each, the loss must fall,
    and the launch counters must grow by one step's launches per step (K1
    with bf16 operands in the fft domain, none with complex64; K2 on its
    upcast operands in the coord domain).  Returns the launches of the
    phase and each kernel's launches per step."""
    reset_counts()
    per_step_seen = {}
    for act, domain in itertools.product(("identity", "leaky_relu"),
                                         ("fft", "coord")):
        want = ((0, K1_PER_FFT_STEP, 0, RS_PER_FFT_STEP) if domain == "fft"
                else (0, 0, K2_PER_COORD_STEP, 0))
        before = counts()
        t0 = time.perf_counter()
        recs = _cli_records(["train", "--nx", "256", "--layers", "3",
                             "--batch", "8", "--seed", "0", "--log-every",
                             "1", "--domain", domain, "--bf16", "--steps",
                             str(TRAIN_STEPS), "--activation", act,
                             "--ckpt", str(tmp / f"bf16_{domain}_{act}")])
        wall = time.perf_counter() - t0
        g = grown(before)
        grew = (g["k1"], g["k1bf"], g["k2"], g["rs"])
        losses = [r["loss"] for r in recs]
        tag = f"train {domain} --bf16 --activation {act}"
        check([r["step"] for r in recs] == list(range(TRAIN_STEPS)),
              f"{tag}: logged {[r['step'] for r in recs]}")
        check(all(math.isfinite(v) for v in losses),
              f"{tag}: non-finite loss {losses}")
        check(grew == tuple(w * TRAIN_STEPS for w in want),
              f"{tag}: {TRAIN_STEPS} steps launched K1 {grew[0]}x, K1 bf16 "
              f"{grew[1]}x, K2 {grew[2]}x, the resize {grew[3]}x; expected "
              f"{want} per step")
        check(losses[-1] < losses[0],
              f"{tag}: the loss did not fall: {losses}")
        print(f"{tag} 256x256 b8 steps 0-{TRAIN_STEPS - 1}: loss "
              f"{losses[0]:.6g} -> {losses[-1]:.6g}; launches K1 "
              f"+{grew[0]} K1 bf16 +{grew[1]} K2 +{grew[2]} resize "
              f"+{grew[3]} ({want} per step); {wall:.2f} s wall", flush=True)
        kern, i = ("k1bf", 1) if domain == "fft" else ("k2", 2)
        per_step_seen[kern] = grew[i] / TRAIN_STEPS
    return counts(), per_step_seen


@contextlib.contextmanager
def card_routes():
    """Inside the block the CPU routes its convs as the card does: every
    batched spectral conv through SpectralConvFused, every coord conv with
    M*D <= 64 and at most 25 taps through ConvValid (each running its
    kernel's plain version on the CPU).  The coord shapes are the
    routing predicate's own (``coord._kernel_shape``)."""
    from spectralae_torch.ops import coord, spectral
    from spectralae_torch.ops import spectral_kernels as sk
    conv, auto = spectral.spectral_conv, coord._auto_conv_kernel

    def fused(X, C, b, nx, ny, *, scale_by_dm=True, compute_dtype=None,
              m_global=None):
        return sk.spectral_conv_fused(X, C, b, nx, ny, scale_by_dm,
                                      compute_dtype, m_global=m_global)
    spectral.spectral_conv = fused
    coord._auto_conv_kernel = lambda x, c: coord._kernel_shape(c)
    try:
        yield
    finally:
        spectral.spectral_conv, coord._auto_conv_kernel = conv, auto


def phase_train_vs_cpu(tmp: Path) -> None:
    """The same 3-step run (weights and frames from one seed) on the card
    and on the CPU, where the plain versions run, in float32 and with
    ``--bf16``: parameters, momentum and the last raw gradient, each held
    on its own (most gradients are above GRAD_CLIP, where the update sees
    only their sign).  bf16 is held against the CPU on the card's routes
    (TOL_BF16): the CPU's own routes (einsum, F.conv2d) round at other
    points and are not a like-for-like reference."""
    from spectralae_torch.io import checkpoint as ckpt

    def three_steps(domain, device, bf16, routes=None):
        dest = tmp / f"three_{domain}_{device}_{int(bf16)}_{bool(routes)}"
        with routes() if routes else contextlib.nullcontext():
            _cli_records(["train", "--nx", "256", "--layers", "3",
                          "--batch", "8", "--steps", "3", "--seed", "0",
                          "--domain", domain, "--device", device,
                          "--ckpt", str(dest)] + (["--bf16"] if bf16 else []))
        params, _, opt, _ = ckpt.load(dest)
        return [torch.cat([t.reshape(-1) for t in tree.leaves()])
                for tree in (params, opt.mom, opt.prev_grad)]

    def held(tag, against, got, want, tols):
        for name, a, b, t in zip(("parameters", "momentum", "raw gradient"),
                                 got, want, tols):
            err = rel_err(a, b)
            print(f"train {tag} 3 steps, card vs {against}: {name} rel "
                  f"{err:.3e} (tol {t:.3e})", flush=True)
            check(err <= t, f"train {tag}: card and {against} disagree in "
                  f"{name}: {err:.3e} > {t:.3e}")

    for domain in ("fft", "coord"):
        cpu32 = three_steps(domain, "cpu", False)
        held(domain, "CPU port", three_steps(domain, "cuda", False), cpu32,
             (TOL_FFT, TOL_MOM, TOL_FFT) if domain == "fft"
             else (TOL_COORD, TOL_MOM, TOL_COORD))
        card = three_steps(domain, "cuda", True)
        held(f"{domain} --bf16", "CPU port on the card's routes", card,
             three_steps(domain, "cpu", True, card_routes), TOL_BF16[domain])


# ------------------------------------------ 7: the interactive loop

def run_launches(keys: str, frames: int, dump_every: int,
                 stages: int) -> dict:
    """K1, K2, K3 and resize launches a ``run`` of ``frames`` frames with
    the key script ``keys`` makes on the card: a fft frame runs one K1 per
    stage (and as many again where a view dump recomputes the tape: no
    training and no 'g'), and one resize with each (every stage of the
    default net and every pair 'n' adds pools at scale 2; the burst trains
    on the forward's tape and pools nothing), a fft burst two K3, a
    coordinate frame two K2 (the 3->10 and 10->3 convs; the coord step's
    transposes run on cuDNN)."""
    fft, sel, fft_l = True, False, False
    want = dict(k1=0, k2=0, k3=0)
    for i in range(frames):
        if fft:
            want["k1"] += stages
            if dump_every and i % dump_every == 0 and not (sel or fft_l):
                want["k1"] += stages
            if sel:
                want["k3"] += 2
                sel = False
        else:
            want["k2"] += 2
        key = keys[i] if i < len(keys) else ""
        if key == "1":
            sel = not sel
        elif key == "f":
            fft = not fft
        elif key == "g":
            fft_l = not fft_l
        elif key == "n":
            stages += 2
        elif key == "d" and stages > 2:
            stages -= 2
    want["rs"] = want["k1"]
    return want


def _k123_plains() -> list:
    """The plain versions of K1, K2, K3 and the resize."""
    from spectralae_torch.ops import coord_kernels as ck
    from spectralae_torch.ops import spectral
    from spectralae_torch.ops import spectral_kernels as sk
    from spectralae_torch.ops import window_kernels as wk
    return [(sk, "cmul_contract_plain"), (ck, "conv_valid_plain"),
            (wk, "corr_pair_windows_plain"), (spectral, "resize_plain")]


def _run_cli(tmp: Path) -> dict:
    """``run`` through the CLI at 256^2 on the default 3-pair net with
    RUN_KEYS; returns the launches it made."""
    from spectralae_torch.cli.main import main as cli
    work, views = tmp / "run", tmp / "run" / "views"
    work.mkdir()
    fallbacks = []
    reset_counts()
    before = counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with kernel_inputs() as kept, guard_plains(_k123_plains(), fallbacks), \
            contextlib.chdir(work), contextlib.redirect_stdout(buf):
        cli(["run", "--nx", "256", "--layers", "3", "--seed", "0",
             "--frames", str(RUN_FRAMES), "--keys", RUN_KEYS,
             "--dump-every", str(RUN_DUMP), "--outdir", str(views)])
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    got = grown(before)
    want = dict.fromkeys(got, 0)
    want.update(run_launches(RUN_KEYS, RUN_FRAMES, RUN_DUMP, 6))
    check(got == want, f"run: launches {got}, expected {want}")
    check(not fallbacks, f"run: plain versions ran on the card: {fallbacks}")
    launched = counts()
    hold_kernel_inputs("run", kept)
    mses = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^frame (\d+): [\d.]+ ms  mse: (\S+)$", out, re.M)}
    check(all(math.isfinite(v) for v in mses.values()),
          f"run: non-finite mse {mses}")
    a, b = RUN_COORD_FALL
    check(mses[b] < mses[a], f"run: the coord mse of the innermost pair did "
          f"not fall over frames {a}-{b}: {mses[a]:.6g} -> {mses[b]:.6g}")
    check("Network structure" in out and "key 's' -> (" in out
          and "key 'l' -> None" in out, "run: 'i', 's' or 'l' failed:\n"
          + "\n".join(line for line in out.splitlines()
                      if line.startswith("key")))
    check(len(list((work / "weights").glob("*.conv"))) == 2,
          "run: 's' wrote no .conv pair")
    dumps = sorted(pth.name for pth in views.iterdir())
    for i in range(0, RUN_FRAMES, RUN_DUMP):
        for view in ("input", "output", "feature_map", "kernel"):
            check(f"{view}_{i:05d}.png" in dumps, f"run: no {view} view of "
                  f"frame {i}")
    check("spectrum_00002.png" in dumps and "layer_12_00002.png" in dumps,
          "run: no 'g' views of frame 2")
    print(f"run 256x256 3 pairs, {RUN_FRAMES} frames, keys {RUN_KEYS!r}: "
          f"launches {({k: v for k, v in got.items() if v})} (as the keys "
          f"imply); coord mse of the innermost pair frame {a} "
          f"{mses[a]:.6g} -> frame {b} {mses[b]:.6g}; {len(dumps)} PNGs; "
          f"{wall:.2f} s CLI wall; host codec route: {_codec_route()}",
          flush=True)
    return launched


def _codec_route() -> str:
    """Which route the pipeline's host stages take in this checkout."""
    from spectralae_torch.data import native
    if native.available():
        return (f"the native library ({native._lib._name}) for the resize, "
                "the batch stage, .y4m and PNG decoding; numpy for the "
                "frame conversions")
    return "numpy (the native library is not built)"


def _engine_vs_cpu(tmp: Path, frames: list) -> None:
    """RUN_KEYS through the Engine API on the card and on the CPU, with
    Config(fft_iters=ENGINE_FFT_ITERS), one seed and cuDNN's TF32 at
    PyTorch's default (the engine holds its library convs in IEEE float32
    itself); each frame starts both from the card's state.  Every frame's
    reconstruction and activation tape (computed by the step, or recomputed
    by the view dump of a ``run --dump-every RUN_DUMP`` frame) at TOL_FFT
    (fft) or TOL_COORD (coord); after every train step the selected pair,
    the momentum (coord) and the last mse: coord steps at TOL_COORD
    (momentum TOL_MOM); the fft burst (the correlation burst on the card,
    the omega-space one on the CPU) in the weights at TOL_STREAM_W and in
    the last mse as each side's returned weights give it (pair_mse64) at
    TOL_STREAM_MSE.  The weights 'n' draws are held bit for bit."""
    from spectralae_torch.core.config import Config
    from spectralae_torch.model import engine as engine_mod
    from spectralae_torch.model.engine import Engine
    bursts = {}
    burst = engine_mod.auto_burst

    def recorded_burst(x, *a, **kw):
        r = burst(x, *a, **kw)
        bursts[x.device.type] = (float(r.mses[-1]),
                                 pair_mse64(x, r.c, r.f, r.b, r.p))
        return r
    engines = {}
    for dev in ("cuda", "cpu"):
        eng = Engine(Config(nx=256, ny=256, fft_iters=ENGINE_FFT_ITERS),
                     seed=0, device=dev)
        eng.add_layer()
        eng.add_layer()
        eng.select_layer(0)
        (tmp / f"engine_{dev}").mkdir()
        engines[dev] = eng
    worst, own = {}, {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    engine_mod.auto_burst = recorded_burst
    try:
        _engine_frames(tmp, frames, engines, bursts, worst, own)
    finally:
        engine_mod.auto_burst = burst
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"engine 256x256 3 pairs, {len(frames)} frames of {RUN_KEYS!r} "
          f"(fft_iters={ENGINE_FFT_ITERS}, cuDNN TF32 on), card vs CPU port "
          "from the same state each frame: " + ", ".join(
              f"{mode} {name} {e:.3e}" for (mode, name), e in worst.items())
          + f" (tol: fft {TOL_FFT:g}, coord {TOL_COORD:g}, momentum "
          f"{TOL_MOM:g}; burst weights {TOL_STREAM_W:g}, last mse from the "
          f"weights in float64 {TOL_STREAM_MSE:g}); each burst's own last "
          "mse against that: " + ", ".join(
              f"{dev} {e:.3e}" for dev, e in own.items())
          + "; 'n' drew the same weights", flush=True)


def _engine_frames(tmp: Path, frames: list, engines: dict, bursts: dict,
                   worst: dict, own: dict) -> None:
    from spectralae_torch.model.engine import dispatch_key
    card, cpu = engines["cuda"], engines["cpu"]

    def hold(i, mode, name, e, tol):
        check(e <= tol, f"engine frame {i} {mode}: card and CPU disagree "
              f"in {name}: {e:.3e} > {tol:g}")
        worst[(mode, name)] = max(worst.get((mode, name), 0.0), e)
    for i, x in enumerate(frames):
        cpu.params = type(card.params).from_leaves(
            [t.cpu() for t in card.params.leaves()])
        cpu._mom = tuple(t.cpu() for t in card._mom)
        cpu._prev_grad = tuple(t.cpu() for t in card._prev_grad)
        trains, fft = card.flags.sel, card.flags.fft
        mode, tol = ("fft", TOL_FFT) if fft else ("coord", TOL_COORD)
        out = [torch.from_numpy(eng.step(x)) for eng in (card, cpu)]
        hold(i, mode, "reconstruction", rel_err(*out), tol)
        if card.layers is None and i % RUN_DUMP == 0:
            for eng in (card, cpu):
                eng.current_views()
        if card.layers is not None:
            hold(i, mode, "tape", max(rel_err(a.cpu(), b) for a, b in
                                      zip(card.layers, cpu.layers)), tol)
        if trains:
            mode = "fft burst" if fft else "coord step"
            n_l = card.flags.n_l
            hold(i, mode, "weights",
                 rel_err(_flat([t.cpu() for t in _pair(card, n_l)]),
                         _flat(_pair(cpu, n_l))),
                 TOL_STREAM_W if fft else TOL_COORD)
            if fft:
                (a_own, a), (b_own, b) = bursts["cuda"], bursts["cpu"]
                hold(i, mode, "last mse", abs(a - b) / b, TOL_STREAM_MSE)
                for dev, (m_own, m) in bursts.items():
                    own[dev] = max(own.get(dev, 0.0), abs(m_own - m) / m)
            else:
                hold(i, mode, "momentum",
                     rel_err(_flat([t.cpu() for t in card._mom]),
                             _flat(cpu._mom)), TOL_MOM)
                hold(i, mode, "last mse",
                     abs(card.last_mse - cpu.last_mse) / abs(cpu.last_mse),
                     TOL_COORD)
        key = RUN_KEYS[i] if i < len(RUN_KEYS) else ""
        for dev, eng in engines.items():
            with contextlib.chdir(tmp / f"engine_{dev}"):
                dispatch_key(eng, key)
        if key in ("n", "e"):
            n_l = card.flags.n_l
            check(all(torch.equal(a.cpu(), b) for a, b in zip(
                _pair(card, n_l), _pair(cpu, n_l))),
                  f"engine '{key}': the card and the CPU drew other weights")


def _pair(eng, n_l: int) -> list:
    enc, dec = eng.params.pair(n_l)
    return [enc.c, enc.b, dec.c, dec.b]


def _engine_times(frame: np.ndarray) -> None:
    """Host ms per frame of the engine at 256^2 (3 pairs, pair 0: the
    burst on its 128^2 input) in each of the run path's modes, with the
    device ms and busy share."""
    from spectralae_torch.core.config import Config
    from spectralae_torch.model.engine import Engine
    eng = Engine(Config(nx=256, ny=256), seed=0, device="cuda")
    eng.add_layer()
    eng.add_layer()
    eng.select_layer(0)
    for label, fft, sel, reps in (("fft inference", True, False, 10),
                                  ("fft burst frame (100 iterations)", True,
                                   True, 3),
                                  ("coord inference", False, False, 10),
                                  ("coord train frame", False, True, 10)):
        eng.flags.fft = fft

        def one_frame(sel=sel):
            eng.flags.sel = sel
            eng.step(frame)
        _breakdown(f"run frame 256x256 3 pairs, {label}", one_frame,
                   reps=reps)


def _coord_stream(tmp: Path) -> dict:
    """``train --mode stream --domain coord`` through the CLI at 256^2
    batch 8 on the innermost pair, with a checkpoint and a resume; then 3
    frames of ``coord_stream`` on the card against the CPU."""
    from spectralae_torch.data import pipeline
    from spectralae_torch.io import checkpoint as ckpt
    from spectralae_torch.core.types import AEParams
    from spectralae_torch.train.streaming import coord_stream
    argv = ["train", "--nx", "256", "--layers", "3", "--batch", "8",
            "--seed", "0", "--log-every", "1", "--mode", "stream",
            "--domain", "coord", "--stream-k", "8", "--train-pair", "2",
            "--ckpt", str(tmp / "coord_stream")]
    fallbacks = []
    reset_counts()
    loss0 = None
    for first, frames in ((0, COORD_STREAM_STEPS),
                          (COORD_STREAM_STEPS, COORD_STREAM_RESUME)):
        extra = ["--resume", str(tmp / "coord_stream")] if first else []
        before = counts()
        t0 = time.perf_counter()
        with guard_plains(_k123_plains(), fallbacks):
            recs = _cli_records(argv + ["--steps", str(first + frames)]
                                + extra)
        wall = time.perf_counter() - t0
        got = grown(before)
        want = dict.fromkeys(got, 0)
        want["k2"] = 2 * frames
        check(got == want, f"coord stream: launches {got}, expected {want}")
        check([r["step"] for r in recs] == list(range(first,
                                                      first + frames)),
              f"coord stream: logged steps {[r['step'] for r in recs]}")
        mses = [r["mse"] for r in recs]
        check(all(math.isfinite(v) for v in mses),
              f"coord stream: non-finite mse {mses}")
        check(ckpt.load(tmp / "coord_stream")[3]["step"] == first + frames,
              "coord stream: checkpoint step")
        if not first:
            check(mses[-1] < mses[0], f"coord stream: the mse did not fall: "
                  f"{mses[0]:.6g} -> {mses[-1]:.6g}")
            loss0 = mses[0]
        else:
            check(mses[0] < loss0, f"coord stream resumed: first mse "
                  f"{mses[0]:.6g} not below the first run's {loss0:.6g}")
        print(f"train --mode stream --domain coord 256x256 b8 pair 2 steps "
              f"{first}-{first + frames - 1}{' (resumed)' if first else ''}"
              f": mse {mses[0]:.6g} -> {mses[-1]:.6g}; launches K2 "
              f"+{got['k2']} (2 per frame); {wall:.2f} s CLI wall, "
              f"{frames / wall:.2f} frames/s ({8 * frames / wall:.1f} "
              "images/s)", flush=True)
    check(not fallbacks, f"coord stream: plain versions ran on the card: "
          f"{fallbacks}")
    launched = counts()
    params, spec = _net(256)
    src = pipeline.synthetic_frames(256, 256, seed=3)
    xs = torch.from_numpy(np.stack([pipeline.frame_to_tensor(f) for f in
                                    itertools.islice(src, 8 *
                                                     COORD_CMP_FRAMES)]))
    xs = xs.reshape(COORD_CMP_FRAMES, 8, 3, 256, 256)
    runs = {}
    for dev in ("cuda", "cpu"):
        prm = AEParams.from_leaves([t.to(dev) for t in params.leaves()])
        r = coord_stream(xs.to(dev), prm, spec.scales, 2)
        runs[dev] = (_flat([t.cpu() for t in r.params.leaves()]),
                     _flat([t.cpu() for t in r.mom]), r.mses.cpu())
    errs = {name: (rel_err(a, b), t) for name, a, b, t in zip(
        ("weights", "momentum", "mses"), runs["cuda"], runs["cpu"],
        (TOL_COORD, TOL_MOM, TOL_COORD))}
    print(f"coord stream {COORD_CMP_FRAMES} frames 256x256 b8 pair 2, card "
          "vs CPU port: " + ", ".join(f"{k} {e:.3e} (tol {t:g})"
                                      for k, (e, t) in errs.items()),
          flush=True)
    for k, (e, t) in errs.items():
        check(e <= t, f"coord stream card vs CPU: {k} {e:.3e} > {t:g}")
    prm = AEParams.from_leaves([t.cuda() for t in params.leaves()])
    xs8 = xs[:1].cuda().expand(8, -1, -1, -1, -1).contiguous()
    ms = _host_ms(lambda: coord_stream(xs8, prm, spec.scales, 2).mses.cpu(),
                  3)
    print(f"coord stream flush of 8 frames 256x256 b8 (library call): host "
          f"{ms:.4f} ms, {8 / ms * 1e3:.2f} frames/s ({64 / ms * 1e3:.1f} "
          "images/s)", flush=True)
    return launched


def _eval(tmp: Path) -> None:
    """``eval`` on the card and on the CPU of phase 5's checkpoints (each
    in its domain) and phase 4's forward artifacts: mse_per_pixel within
    1e-5 relative."""
    for what, argv in (
            ("checkpoint fft", ["--from-ckpt", str(tmp / "train_fft"),
                                "--domain", "fft"]),
            ("checkpoint coord", ["--from-ckpt", str(tmp / "train_coord"),
                                  "--domain", "coord"]),
            ("artifact fft", ["--model", str(tmp / "fft" / "forward")]),
            ("artifact coord", ["--model", str(tmp / "coord" / "forward")])):
        got = {}
        before = counts()
        for dev in ("cuda", "cpu"):
            (rec,) = _cli_records(["eval", "--steps", "2", "--batch", "4",
                                   "--seed", "5", "--device", dev] + argv)
            got[dev] = rec
        grew = grown(before)
        a, b = got["cuda"]["mse_per_pixel"], got["cpu"]["mse_per_pixel"]
        err = abs(a - b) / abs(b)
        print(f"eval {what} 256x256 8 frames: mse_per_pixel card {a} CPU {b}"
              f" (rel {err:.3e}, tol 1e-5); psnr {got['cuda']['psnr_db']} "
              f"dB; launches K1 +{grew['k1']} K2 +{grew['k2']}", flush=True)
        check(got["cuda"]["frames"] == got["cpu"]["frames"] == 8,
              f"eval {what}: frames {got}")
        check(err <= 1e-5, f"eval {what}: card {a} vs CPU {b}")
        check(grew["k1" if "fft" in what else "k2"] > 0,
              f"eval {what}: its kernel was not launched")


def phase_engine(tmp: Path) -> tuple[dict, dict]:
    """Phase 7 (see the module docstring).  Returns the launches of the
    run path and of the coord stream path."""
    from spectralae_torch.data import pipeline
    frames = [pipeline.frame_to_tensor(f) for f in itertools.islice(
        pipeline.synthetic_frames(256, 256, seed=0), RUN_FRAMES)]
    t0 = time.perf_counter()
    run = _run_cli(tmp)
    _engine_vs_cpu(tmp, frames)
    _engine_times(frames[0])
    stream = _coord_stream(tmp)
    _eval(tmp)
    print(f"phase 7 took {time.perf_counter() - t0:.1f} s", flush=True)
    return run, stream


# ------------------------------------------ 8: distributed training

# two ranks on the one card (gloo; NCCL refuses two ranks on one GPU): the
# rendezvous, every collective and the whole run wait at most this long
DIST_TIMEOUT = 240.0
DIST_ITERS = 10          # inner iterations of each distributed burst
# the distributed bursts on two ranks against the single process on the
# card: the JAX tests' own tolerances, rtol / atol, for the fused TP burst
# (test_tp_proof.py:81-102) and the DP burst (test_fft_dp.py:86-99)
TOL_TP, TOL_DP = (3e-5, 1e-6), (1e-4, 1e-5)
# K4's row slabs: 2 and 4 even slabs, and 3 slabs of cdiv(n, 3) rows whose
# last one is padded
SLAB_COVERS = ((2, False), (4, False), (3, True))
# K4's outputs, and the tolerance of the slabs' sums against the full call
# (a different float order from the full call's block sum, so not bit for
# bit: the JAX package's row-slab test holds them at 1e-6)
K4_OUTPUTS = ("XX", "EGw", "seg", "e0")
TOL_SLAB_SUM = 1e-6
# the TP burst's frames (pair 0's input is half their size) and slab rows
TP_FRAMES, TP_SLAB = 1024, 256
# the model axis of the train step on mesh (1, 2): steps in each domain of
# the default net at 256^2 b8, against the single process's steps on the
# card: the parameters and the losses norm-relative (each stage's conv on
# the rank's channel slice: the same float32 products, the whole stages'
# partial sums added by an all_reduce in another order), the momentum at
# TOL_MOM; spatial_forward against forward_fft at rtol / atol
# (test_modern_dist.py:190-206)
TP_STEPS = 3
TOL_TP_STEP = 1e-5
TOL_TP_FWD = (1e-5, 1e-4)


def _slabs(X: torch.Tensor, k: int, uneven: bool):
    """A cover of X's rows by ``k`` slabs ([start row, contiguous slab]),
    zero-padded to whole slabs: n // k rows each, or cdiv(n, k) (the last
    slab padded) when ``uneven``."""
    n = X.shape[-2]
    chunk = -(-n // k) if uneven else n // k
    nsl = -(-n // chunk)
    Xp = torch.nn.functional.pad(X, (0, 0, 0, nsl * chunk - n))
    return [(i * chunk, Xp[:, :, i * chunk:(i + 1) * chunk].contiguous())
            for i in range(nsl)]


def _split_ms(fn, names) -> tuple[float, float]:
    """One profile of ``fn()``: the device ms of the operations whose name
    holds one of ``names``, and of the others."""
    own = other = 0.0
    for key, ms, k, _ in device_ops(fn):
        if any(n in key for n in names):
            own += ms * k
        else:
            other += ms * k
    return own, other


def _slab_errs(got, want, row0: int, label: str) -> float:
    """Hold one slab's K4 outputs against its plain version's, each on its
    own: XX, EGw and seg at TOL_WINDOWS norm-relative; e0 exactly 0 on a
    slab that does not hold row 0, else at TOL_WINDOWS.  Returns the
    largest relative error."""
    errs = []
    for name, g, w in zip(K4_OUTPUTS, got, want):
        if name == "e0" and row0 > 0:
            check(not bool(torch.any(g != 0)), f"{label}: e0 is not 0 on a "
                  f"slab without row 0 (max |e0| {float(g.abs().max()):.3e})")
            continue
        errs.append(rel_err(g, w))
        check(errs[-1] <= TOL_WINDOWS,
              f"{label}: {name} rel {errs[-1]:.3e} (tol {TOL_WINDOWS:g})")
    return max(errs)


def phase_dist_slabs(gen: torch.Generator) -> tuple[dict, float]:
    """K4's row_slab mode against its plain version at the precompute
    shapes of pair 0 (WINDOW_SIZES), float32 and bf16 signal, over each of
    SLAB_COVERS: each slab's outputs held one by one against its plain
    version (:func:`_slab_errs`), three runs bit for bit, the slabs' sum of
    each output against the full call's at TOL_SLAB_SUM, each
    slab's device ms (kernel and plain version in one profile) beside the
    full call's and the bound of the slab's live rows.  Returns the rows by
    (frame size, variant) and the largest absolute error."""
    from spectralae_torch.ops import window_kernels as wk
    from spectralae_torch.train import fft_corr
    m, d, nk = 10, 3, 5
    c, f = ((torch.rand(*shape, device="cuda", generator=gen) - 0.5)
            for shape in ((m, d, nk, nk), (d, m, nk, nk)))
    taps = fft_corr._composed_taps(c, f, fft_corr._maps_on(nk, nk, c.device),
                                   d, m, nk * nk)
    nk2 = taps.shape[-1]
    h2, s1 = nk2 // 2, 1.0 / (m * d)
    rows, worst = {}, 0.0
    for frames, batch in WINDOW_SIZES:
        n = frames // 2
        X = torch.fft.rfft2(torch.rand(batch, d, n, n, device="cuda",
                                       generator=gen) * 255)
        for variant, sd in (("f32", None), ("bf16", torch.bfloat16)):
            tag = f"{variant} signal {n}x{n} b{batch} ({frames}^2 frames)"

            def full(sd=sd):
                return wk.anchor_windows(X, taps, n, n, h2, h2, s1,
                                         signal_dtype=sd)
            whole = full()
            full_ms = device_ms(full, K4_GRIDS)
            covers = {}
            for k, uneven in SLAB_COVERS:
                slabs, parts = [], []
                for row0, Xl in _slabs(X, k, uneven):
                    live = min(Xl.shape[-2], n - row0)

                    def kern(Xl=Xl, row0=row0, sd=sd):
                        return wk.anchor_windows(Xl, taps, n, n, h2, h2, s1,
                                                 row_slab=row0,
                                                 signal_dtype=sd)

                    def plain(Xl=Xl, row0=row0, sd=sd):
                        return wk.anchor_windows_plain(
                            Xl, taps, n, n, h2, h2, s1, row_slab=row0,
                            signal_dtype=sd)
                    label = (f"K4 row_slab {tag} slab rows {row0}.."
                             f"{row0 + Xl.shape[-2]} of {n}")
                    runs = [kern() for _ in range(3)]
                    check(all(torch.equal(_flat(runs[0]), _flat(r))
                              for r in runs[1:]), f"{label} does not repeat")
                    got, want = runs[0], plain()
                    err = _slab_errs(got, want, row0, label)
                    worst = max(worst, float(
                        (_flat(got) - _flat(want)).abs().max()))
                    ms, plain_ms = _split_ms(lambda: (kern(), plain()),
                                             K4_GRIDS)
                    bound = k4_bound(batch, d, n, nk2, sd is not None,
                                     rows=live)
                    plan = wk.window_plan(True, batch, d, d, Xl.shape[-2],
                                          n // 2 + 1, h2, h2)
                    print(f"{label} ({live} live): rel {err:.3e} (tol "
                          f"{TOL_WINDOWS:g}); three runs bit for bit; "
                          f"device: kernel {ms:.4f} ms plain {plain_ms:.4f} "
                          f"ms bound {bound[0]:.4f} ms ({bound[1]}); grid "
                          f"{plan.grid}", flush=True)
                    parts.append(got)
                    slabs.append({"row0": row0, "rows": Xl.shape[-2],
                                  "live": live, "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": bound[0],
                                  "bound_by": bound[1], "rel": err})
                # the slabs' e0 is 0 but on the slab holding row 0, so the
                # partials of every output sum to the full call's
                sums = {}
                for i, name in enumerate(K4_OUTPUTS):
                    sums[name] = rel_err(sum(p[i] for p in parts), whole[i])
                    check(sums[name] <= TOL_SLAB_SUM,
                          f"K4 row_slab {tag}: {len(parts)} slabs' {name} "
                          f"sums to the full call's within "
                          f"{sums[name]:.3e} (tol {TOL_SLAB_SUM:g})")
                err = max(sums.values())
                cover = f"{len(parts)}{' uneven' if uneven else ''}"
                print(f"K4 row_slab {tag}: the {cover} slabs' sum against "
                      f"the full call: rel " + ", ".join(
                          f"{k} {v:.3e}" for k, v in sums.items())
                      + f" (tol {TOL_SLAB_SUM:g}); the full call "
                      f"{full_ms:.4f} ms, the slabs "
                      f"{sum(r['ms'] for r in slabs):.4f} ms", flush=True)
                covers[cover] = {"slabs": slabs, "sum_rel": err}
            rows[(frames, variant)] = {"full_ms": full_ms, "covers": covers}
    return rows, worst


def _dist_inputs() -> dict:
    """The distributed phase's inputs, the same in every process: the
    default net's pair-0 weights, pair 0's input of 256^2 batch-8 frames
    (128^2) with an anchor output, and of TP_FRAMES^2 batch-4 frames."""
    from spectralae_torch.train import fft_corr, streaming
    gen = torch.Generator(device="cuda").manual_seed(8)
    params, spec = _net(256)
    frames = torch.rand(8, 3, 256, 256, device="cuda", generator=gen) * 255
    x = streaming._pair_input(params, frames, spec.scales, 0)
    enc, dec = params.pair(0)
    w = (enc.c, dec.c, enc.b, dec.b)
    big, spec_big = _net(TP_FRAMES)
    x_tp = streaming._pair_input(
        big, torch.rand(4, 3, TP_FRAMES, TP_FRAMES, device="cuda",
                        generator=gen) * 255, spec_big.scales, 0)
    return dict(params=params, spec=spec, frames=frames, x=x, w=w,
                out0=fft_corr._true_forward(x, *w, True), x_tp=x_tp)


def _result(r) -> dict:
    """A burst's weights, MSEs and momentum, by name."""
    return dict(c=r.c, f=r.f, b=r.b, p=r.p, mses=r.mses,
                **{f"mom{i}": t for i, t in enumerate(r.mom)})


def _dist_plains() -> list:
    from spectralae_torch.ops import burst_kernels as bk
    from spectralae_torch.ops import window_kernels as wk
    return _k123_plains() + [(wk, "anchor_windows_plain"),
                             (bk, "grad_project_plain"),
                             (bk, "fused_step_plain")]


@contextlib.contextmanager
def _k4_slabs():
    """Record the ``row_slab`` of every K4 call of the fused precompute."""
    from spectralae_torch.train import fft_corr
    seen, real = [], fft_corr.anchor_windows

    def spy(*a, **kw):
        seen.append(kw.get("row_slab"))
        return real(*a, **kw)
    fft_corr.anchor_windows = spy
    try:
        yield seen
    finally:
        fft_corr.anchor_windows = real


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _twice(fn):
    """``fn()`` twice: the second call's result and host ms; the two
    results must be equal bit for bit (the first call is the warm-up)."""
    first = _flat_any(fn())
    r, ms = _timed(fn)
    check(torch.equal(_flat_any(r), first), "a call does not repeat")
    return r, ms


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _tp_rank(inp: dict) -> dict:
    """The model axis on this rank of mesh (1, 2): TP_STEPS
    ``distributed_train_step`` steps in each domain from ``shard_params``
    of the default net (256^2 b8 frames), each timed (host ms) with its
    collectives; then ``spatial_forward`` twice (the second timed, both
    bit for bit).  The launches of each (counters and the launch log's
    shapes) and the results gathered back to whole parameters, on the
    CPU."""
    from spectralae_torch.core.types import init_opt_state
    from spectralae_torch.dist import collectives
    from spectralae_torch.dist import mesh as dmesh
    mesh = dmesh.make_mesh(1, 2)
    params, frames = inp["params"], inp["frames"]
    scales = inp["spec"].scales
    step = dmesh.distributed_train_step(mesh)
    out = {}
    for domain in ("fft", "coord"):
        sp = dmesh.shard_params(params, mesh)
        so = dmesh.shard_opt_state(init_opt_state(params), params, mesh)
        ms, losses, logs = [], [], []
        reset_counts()
        with launch_log() as log:
            for _ in range(TP_STEPS):
                collectives.reset()
                r, t = _timed(lambda: step(sp, so, frames, scales,
                                           domain=domain))
                logs.append(list(collectives.COLLECTIVES))
                sp, so = r.params, r.opt
                ms.append(t)
                losses.append(r.loss.cpu())
        launched = counts()
        whole = dmesh.gather_params(sp, mesh)
        mom = dmesh.gather_opt_state(so, mesh).mom
        out[domain] = dict(
            params=[t.cpu() for t in whole.leaves()],
            mom=[t.cpu() for t in mom.leaves()], losses=losses, ms=ms,
            collectives=logs, launches=launched, log=log,
            layout=[tuple(lay) for lay in sp.layout])
    fwd = dmesh.spatial_forward(mesh, scales)
    reset_counts()
    with launch_log() as log:
        collectives.reset()
        y, ms = _twice(lambda: fwd(params, frames))
    out["forward"] = dict(out=y.cpu(), ms=ms, launches=counts(), log=log,
                          collectives=list(collectives.COLLECTIVES))
    return out


def _dist_rank(rank: int) -> dict:
    """One of the two gloo ranks on the card: the DP corr burst on mesh
    (2, 1) and the fused TP burst (K4 on this rank's row slab) on mesh
    (1, 2), each called twice (the second timed); each with its launches
    over both calls, its K4 row slabs and its host ms."""
    from spectralae_torch import _kernels
    from spectralae_torch.dist import mesh as dmesh
    from spectralae_torch.train.fft_dp import distributed_burst
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = _kernels.build()
    inp = _dist_inputs()
    out = {"build_seconds": build.seconds, "backend": dist.get_backend()}
    fallbacks = []
    with guard_plains(_dist_plains(), fallbacks):
        dp = dmesh.make_mesh(2, 1)
        x_l = dmesh.shard_batch(inp["x"], dp)
        o_l = dmesh.shard_batch(inp["out0"], dp)
        reset_counts()
        r, ms = _twice(lambda: distributed_burst(dp, iters=DIST_ITERS)(
            x_l, x_l, o_l, *inp["w"]))
        out["dp"] = dict(result={k: t.cpu() for k, t in _result(r).items()},
                         ms=ms,
                         launches=counts(), frames=tuple(x_l.shape))
        tp = dmesh.make_mesh(1, 2)
        reset_counts()
        with _k4_slabs() as seen:
            r, ms = _twice(lambda: distributed_burst(
                tp, iters=DIST_ITERS, fused=True)(inp["x_tp"], *inp["w"]))
        out["tp"] = dict(result={k: t.cpu() for k, t in _result(r).items()},
                         ms=ms,
                         launches=counts(), row_slabs=seen,
                         frames=tuple(inp["x_tp"].shape))
        # the coord steps' cuDNN backward sums with atomics by default
        torch.backends.cudnn.deterministic = True
        out["model"] = _tp_rank(inp)
    out["fallbacks"] = fallbacks
    return out


def _tp_single(inp: dict) -> dict:
    """The single process's counterpart of :func:`_tp_rank` on the card:
    TP_STEPS ``train_step`` steps in each domain, each timed, and
    ``forward_fft`` twice (the second timed)."""
    from spectralae_torch.core.types import init_opt_state
    from spectralae_torch.model import autoencoder as model
    from spectralae_torch.train import modern
    params, frames = inp["params"], inp["frames"]
    scales = inp["spec"].scales
    out = {}
    for domain in ("fft", "coord"):
        p, opt = params, init_opt_state(params)
        ms, losses = [], []
        for _ in range(TP_STEPS):
            r, t = _timed(lambda: modern.train_step(p, opt, frames, scales,
                                                    domain=domain))
            p, opt = r.params, r.opt
            ms.append(t)
            losses.append(r.loss.cpu())
        out[domain] = dict(params=[t.cpu() for t in p.leaves()],
                           mom=[t.cpu() for t in opt.mom.leaves()],
                           losses=losses, ms=ms)
    y, ms = _twice(lambda: model.forward_fft(params, frames, scales))
    out["forward"] = dict(out=y.cpu(), ms=ms)
    return out


def _tp_launch_shapes(spec, b: int, rank: int) -> dict:
    """The launches one model-axis step and one spatial_forward make on
    a rank of mesh (1, 2), by the layout (the default net: stages 0-4
    sharded, M = 5 a rank; the 10 -> 3 last stage whole, on its gathered
    input): K1's forward launches of a fft step (keys as
    :func:`k1_key`), the count of its backward ones (dC of every stage, dX
    of every stage but 0), K2's launches of a coord step (the route
    decided on the whole stage: K2 where M·D <= 64, so stages 0 and 5) and
    K1's of the forward, on row slabs, the bias on rank 0's."""
    n = 2
    fft, k2, rows = [], [], []
    for s in spec.stages:
        w = s.nx * (s.ny // 2 + 1)
        part = (s.m // n if s.m % n == 0 else s.m, s.d)
        fft.append(((b, s.d, w), (s.d, part[0], w), False, True))
        if s.m * s.d <= 64:
            k2.append(((b, part[1], s.nx + s.nk - 1, s.ny + s.nl - 1),
                       part + (s.nk, s.nl)))
        ws = s.nx // n * (s.ny // 2 + 1)
        rows.append(((b, s.d, ws), (s.d, s.m, ws), False, rank == 0))
    return dict(fft=fft, backward=2 * len(spec.stages) - 1, coord=k2,
                forward=rows)


def _tp_held(label: str, got: dict, want: dict) -> str:
    """A model-axis run's gathered parameters and losses within
    TOL_TP_STEP norm-relative of the single process's, each leaf and step,
    the momentum within TOL_MOM; returns what was measured."""
    p = max(rel_err(g, w) for g, w in zip(got["params"], want["params"]))
    loss = max(rel_err(g, w) for g, w in zip(got["losses"],
                                             want["losses"]))
    mom = max(rel_err(g, w) for g, w in zip(got["mom"], want["mom"]))
    check(p <= TOL_TP_STEP and loss <= TOL_TP_STEP and mom <= TOL_MOM,
          f"{label}: params rel {p:.3e}, losses rel {loss:.3e} (tol "
          f"{TOL_TP_STEP:g}), momentum rel {mom:.3e} (tol {TOL_MOM:g})")
    return (f"params rel {p:.3e}, losses rel {loss:.3e} (tol "
            f"{TOL_TP_STEP:g}), momentum rel {mom:.3e} (tol {TOL_MOM:g})")


def _tp_check(ranks: list, single: dict, spec, b: int) -> None:
    """Hold both ranks' model-axis runs against the single process and
    each other, check their launches and collectives, and print them."""
    from spectralae_torch.dist import model_axis
    card = card_line()
    for rank, r in enumerate(ranks):
        want = _tp_launch_shapes(spec, b, rank)
        for domain in ("fft", "coord"):
            got = r["model"][domain]
            other = ranks[1 - rank]["model"][domain]
            check(all(torch.equal(a, o) for k in ("params", "mom", "losses")
                      for a, o in zip(got[k], other[k])),
                  f"model axis {domain}: the ranks' gathered results differ")
            held = _tp_held(f"rank {rank} model axis {domain}", got,
                            single[domain])
            k1, k2 = got["launches"]["k1"], got["launches"]["k2"]
            if domain == "fft":
                fwd = [k for k in got["log"]["k1"] if not k[2]]
                check(k1 == TP_STEPS * K1_PER_FFT_STEP and k2 == 0
                      and fwd == want["fft"] * TP_STEPS
                      and k1 - len(fwd) == TP_STEPS * want["backward"],
                      f"rank {rank} model axis fft: K1 {k1}, K2 {k2}, "
                      f"forward launches {fwd}")
                seen = (f"K1 {k1} launches, the forward's q (K, M) "
                        + ", ".join(f"{q[0]}x{q[1]}"
                                    for _, q, _, _ in want["fft"]))
            else:
                check(k1 == 0 and got["log"]["k2"] == want["coord"]
                      * TP_STEPS, f"rank {rank} model axis coord: K1 {k1},"
                      f" K2 {got['log']['k2']}")
                seen = (f"K2 {k2} launches (stages 0 and 5, w "
                        + ", ".join(str(w) for _, w in want["coord"])
                        + "; stages 1-4 10 -> 10 on cuDNN)")
            steps = [sorted(c) for c in got["collectives"]]
            plan = model_axis.step_collectives(spec, 2, b, domain)
            check(all(c == plan for c in steps),
                  f"rank {rank} model axis {domain}: collectives "
                  f"{steps[0]}, the docstring's {plan}")
            print(f"dist gloo rank {rank} model axis (1, 2) {domain} "
                  f"{spec.nx}^2 b{b}: {TP_STEPS} steps host ms "
                  + ", ".join(f"{t:.2f}" for t in got["ms"])
                  + " (single process "
                  + ", ".join(f"{t:.2f}" for t in single[domain]["ms"])
                  + f"); {held}; {seen}, no plain version; a step's "
                  f"collectives: " + ", ".join(f"{op} {e}" for op, e in
                                               got["collectives"][-1])
                  + f"; layout {got['layout']}; {card}", flush=True)
        fwd = r["model"]["forward"]
        rtol, atol = TOL_TP_FWD
        want_y = single["forward"]["out"]
        worst = float(((fwd["out"] - want_y).abs()
                       / (atol + rtol * want_y.abs())).max())
        k1 = fwd["launches"]["k1"]
        # two calls, each one all_gather of each stage's rows (every grid
        # of the default net has an even number of rows)
        plan = model_axis.forward_collectives(spec, 2, b)
        check(worst <= 1.0 and fwd["log"]["k1"] == want["forward"] * 2
              and k1 == 2 * len(want["forward"])
              and len(plan) == len(spec.stages)
              and sorted(fwd["collectives"]) == sorted(plan * 2),
              f"rank {rank} spatial_forward: {worst:.3g} of the tolerance, "
              f"K1 {fwd['log']['k1']}, collectives {fwd['collectives']}")
        check(torch.equal(fwd["out"], ranks[1 - rank]["model"]["forward"][
            "out"]), "spatial_forward: the ranks' reconstructions differ")
        print(f"dist gloo rank {rank} spatial_forward (1, 2) {spec.nx}^2 "
              f"b{b}: "
              f"host {fwd['ms']:.2f} ms (single process forward_fft "
              f"{single['forward']['ms']:.2f} ms); {worst:.3g} of the "
              f"tolerance (rtol {rtol:g} atol {atol:g}); K1 {k1} launches "
              "on row slabs (two calls), the bias on rank 0's; "
              "collectives: " + ", ".join(f"{op} {e}" for op, e in
                                          fwd["collectives"])
              + f"; {card}", flush=True)


def _held(label: str, got: dict, want: dict, tol) -> str:
    """The weights and MSEs of ``got`` within rtol·|want| + atol of
    ``want`` (the JAX tests' assert_allclose, which hold no momentum), the
    momentum within TOL_MOM norm-relative (the last update step carries
    the absolute error of the gradient entries under GRAD_CLIP); returns
    what was measured."""
    rtol, atol = tol
    worst, name = 0.0, ""
    for k in ("c", "f", "b", "p", "mses"):
        g, w = got[k].double().cpu(), want[k].double().cpu()
        r = float(((g - w).abs() / (atol + rtol * w.abs())).max())
        if r >= worst:
            worst, name = r, k
    mom = max(rel_err(got[k].cpu(), want[k].cpu())
              for k in got if k.startswith("mom"))
    check(worst <= 1.0 and mom <= TOL_MOM,
          f"{label}: {name} at {worst:.3g} of the tolerance (rtol {rtol:g}, "
          f"atol {atol:g}); momentum rel {mom:.3e} (tol {TOL_MOM:g})")
    return (f"{worst:.3g} of the tolerance at {name} (rtol {rtol:g} atol "
            f"{atol:g}), momentum rel {mom:.3e}")


def phase_dist(gen: torch.Generator) -> tuple[dict, dict, float]:
    """Phase 8 (see the module docstring).  Returns the K4 slab rows, the
    dist path's launches (this process's NCCL run and both ranks' gloo
    runs) and K4's largest absolute error on the slabs."""
    import torch.distributed as dist
    from spectralae_torch.core.types import init_opt_state
    from spectralae_torch.dist import collectives, multihost
    from spectralae_torch.dist import mesh as dmesh
    from spectralae_torch.model import autoencoder as model
    from spectralae_torch.ops import coord as coord_ops
    from spectralae_torch.train import coord, fft_corr, fft_pallas, modern
    from spectralae_torch.train import streaming
    from spectralae_torch.train.fft import zero_moms
    from spectralae_torch.train.fft_dp import distributed_burst
    t0 = time.perf_counter()
    slabs, worst = phase_dist_slabs(gen)
    print(f"phase 8: K4 row slabs took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # one process on NCCL at world size 1: each distributed call against
    # its single-device call, bit for bit
    inp = _dist_inputs()
    x, w, out0, params = inp["x"], inp["w"], inp["out0"], inp["params"]
    scales = inp["spec"].scales
    acts = model.forward_coord(params, inp["frames"], scales,
                               tap_mode="ref_gpu")
    n_acts = len(acts)
    crop = [coord_ops.center_crop(a, 1) for a in
            (acts[1], acts[n_acts - 2], acts[2])]
    opt = init_opt_state(params)
    xs = torch.stack([x, x.flip(-1)])              # two frames of batch 8
    single = {
        "burst corr": lambda: fft_corr.burst_corr(
            x, x, out0, *w, iters=DIST_ITERS),
        "burst fused": lambda: fft_corr.burst_corr(
            x, None, None, *w, iters=DIST_ITERS),
        "burst use_pallas": lambda: fft_pallas.burst_pallas_fused(
            x, x, out0, *w, iters=DIST_ITERS),
        "coord step": lambda: coord.coord_step_dp(
            *crop, *w, zero_moms(*w), zero_moms(*w)),
        "train step": lambda: modern.train_step(params, opt,
                                                inp["frames"], scales),
        "stream_bursts": lambda: streaming.stream_bursts(
            xs, *w, iters=DIST_ITERS)}
    # the coord step's transposed convs run cuDNN's backward, whose
    # default algorithms sum with atomics: deterministic ones for both calls
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    # each call twice: the second run is timed (warm) and must repeat the
    # first bit for bit
    want, single_ms = {}, {}
    for k, fn in single.items():
        r, single_ms[k] = _twice(fn)
        want[k] = _flat_any(r)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pg_"))
    backend = multihost.init_multihost(f"file://{tmp}/store", 1, 0,
                                       device="cuda:0", timeout=120)
    check(backend == "nccl", f"world size 1 on the card took {backend}")
    fallbacks = []
    try:
        mesh = dmesh.make_mesh(1, 1)
        data = mesh.axis("data")
        # NCCL makes its communicator at the first collective: not timed
        collectives.check_shards(1, data)
        dist_calls = {
            "burst corr": lambda: distributed_burst(mesh, iters=DIST_ITERS)(
                x, x, out0, *w),
            "burst fused": lambda: distributed_burst(
                mesh, iters=DIST_ITERS, fused=True)(x, *w),
            "burst use_pallas": lambda: distributed_burst(
                mesh, iters=DIST_ITERS, use_pallas=True)(x, x, out0, *w),
            "coord step": lambda: coord.distributed_coord_step(mesh)(
                *crop, *w),
            "train step": lambda: dmesh.distributed_train_step(mesh)(
                params, opt, inp["frames"], scales),
            "stream_bursts": lambda: streaming.stream_bursts(
                xs, *w, iters=DIST_ITERS, axis_name=data)}
        collectives.reset()
        with guard_plains(_dist_plains(), fallbacks):
            reset_counts()
            got, ms = {}, {}
            for k, fn in dist_calls.items():
                r, ms[k] = _twice(fn)
                got[k] = _flat_any(r)
            nccl = counts()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    for k in dist_calls:
        check(torch.equal(got[k], want[k]),
              f"NCCL world size 1: {k} differs from its single-device call")
        print(f"dist NCCL world size 1: {k}: bit for bit with the "
              f"single-device call, twice; host {ms[k]:.2f} ms (the "
              f"single-device call {single_ms[k]:.2f} ms; the second of "
              "two calls each)", flush=True)
    # twice each: the corr burst's precompute (K3 twice), the fused burst
    # and the stream's two frames (K4 once a precompute), the use_pallas
    # body (K5 once, K7 an iteration), the train step (K1 17 times, the
    # resize 11)
    want_launches = dict.fromkeys(nccl, 0)
    want_launches.update(k1=2 * K1_PER_FFT_STEP, rs=2 * RS_PER_FFT_STEP,
                         k3=2 * 2, k4=2 * 3, k5=2, k7=2 * DIST_ITERS)
    check(nccl == want_launches, f"NCCL world size 1: launches {nccl}")
    print(f"dist NCCL world size 1: {sum(collectives.CALLS.values())} "
          f"collectives, {sum(collectives.ELEMENTS.values())} floats; "
          f"launches {nccl}", flush=True)

    # two processes on the one card over gloo: DP on mesh (2, 1), TP on
    # mesh (1, 2), against the single process
    t1 = time.perf_counter()
    ranks = multihost.spawn_ranks(_dist_rank, 2, device="cuda:0",
                                  timeout=DIST_TIMEOUT)
    spawn_s = time.perf_counter() - t1
    want_dp = _result(fft_corr.burst_corr(x, x, out0, *w, iters=DIST_ITERS))
    want_tp = _result(fft_corr.burst_corr(inp["x_tp"], None, None, *w,
                                          iters=DIST_ITERS))
    _tp_check(ranks, _tp_single(inp), inp["spec"], inp["frames"].shape[0])
    launched = dict(nccl)
    for rank, r in enumerate(ranks):
        check(r["build_seconds"] == 0.0 and r["backend"] == "gloo",
              f"rank {rank}: built in {r['build_seconds']} s on "
              f"{r['backend']}")
        check(not r["fallbacks"], f"rank {rank}: plain versions ran on the "
              f"card: {r['fallbacks']}")
        dp, tp = r["dp"], r["tp"]
        ok_dp = _held(f"rank {rank} DP burst", dp["result"], want_dp, TOL_DP)
        ok_tp = _held(f"rank {rank} TP burst", tp["result"], want_tp, TOL_TP)
        # two calls each: K3 twice a DP precompute, K4 once a TP one
        check(dp["launches"]["k3"] == 4 and tp["launches"]["k4"] == 2,
              f"rank {rank}: K3 {dp['launches']['k3']} in two DP bursts, "
              f"K4 {tp['launches']['k4']} in two TP bursts")
        check(tp["row_slabs"] == [rank * TP_SLAB] * 2,
              f"rank {rank}: K4 row slabs {tp['row_slabs']}")
        for part in (dp, tp, r["model"]["fft"], r["model"]["coord"],
                     r["model"]["forward"]):
            for k, v in part["launches"].items():
                launched[k] += v
        print(f"dist gloo rank {rank}: DP corr burst {dp['frames']} "
              f"{DIST_ITERS} iterations host {dp['ms']:.2f} ms, {ok_dp}; "
              f"TP fused burst {tp['frames']} K4 on rows "
              f"{tp['row_slabs'][0]}..{tp['row_slabs'][0] + TP_SLAB} host "
              f"{tp['ms']:.2f} ms, {ok_tp}; the library reused, no plain "
              "version on the card", flush=True)
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s (the two ranks "
          f"{spawn_s:.1f} s)", flush=True)
    return slabs, launched, worst


# the harness's rows phase 9 runs, and the kernels they launch
BENCH_ROWS = tuple(f"fft_burst_100_ms[{impl}]" for impl in (
    "corr", "pallas-fused", "pallas", "itergrid", "dft", "fft")) + (
    "forward_fft_3layer_256_ms", "modern_fft_step_b8_ms",
    "conv_coord_5x5_b8_ms[pallas]", "fft_burst_100_ms_13x13[corr]",
    "fft_burst_100_ms_13x13[pallas-fused]")
BENCH_KERNELS = ("k1", "k2", "k3", "k5", "k6", "k7", "k8")
BENCH_PCT_MAX = 105.0


def phase_bench() -> dict:
    """The benchmark harness (``spectralae_torch.bench``) on the card, short:
    the headline window's six impls, the forward, step and conv groups
    (the 5×5 conv only) and the 13×13 bursts (corr, and K5 and K7 on 169
    taps), each row two chains of two links; the counters
    reset before and read after, the plain versions guarded.  Every row of
    BENCH_ROWS recorded with its host and device ms and no error; the corr
    row's roofline shares at most BENCH_PCT_MAX %; ``device_peaks()``
    names the card.  Prints the rows on one line; returns the launches."""
    from spectralae_torch import bench
    from spectralae_torch.core import roofline
    from spectralae_torch.ops import burst_kernels as bk
    from spectralae_torch.ops import window_kernels as wk
    t0 = time.perf_counter()
    peaks = roofline.device_peaks()
    check(peaks is not None, "device_peaks() names no card for "
          f"{torch.cuda.get_device_name(0)!r}")
    b = bench.Bench(path=None, peaks=peaks)
    ctx = bench.Ctx(torch.device("cuda"), b, links=2, trials=2)
    fallbacks = []
    plains = _k123_plains() + [(wk, "anchor_windows_plain")] + [
        (bk, f"{k}_plain") for k in ("grad_project", "respectra_conv",
                                     "fused_step", "itergrid")]
    reset_counts()
    with guard_plains(plains, fallbacks):
        hl = bench.Headline(ctx).window1()
        bench.forward(ctx)
        bench.steps(ctx)
        bench.conv(ctx, lks=(1,))
        bench.taps13(ctx, hl)
        line = hl.summary()
    launched = counts()
    check(not fallbacks, f"bench: plain versions ran on the card: "
          f"{fallbacks}")
    r = b.results
    errors = {k: v for k, v in r.items() if k.endswith(":error")}
    check(not errors, f"bench: rows failed: {errors}")
    for key in BENCH_ROWS:
        check(r.get(key) is not None and r.get(key + ":median") is not None
              and r.get(key + ":device_ms") is not None,
              f"bench: row {key} not recorded: {r.get(key)}")
    util = r.get("util[fft_burst_100_ms[corr]]") or {}
    shares = {k: util.get(k) for k in ("pct_peak_flops", "pct_peak_bw")}
    check(all(v is not None and v <= BENCH_PCT_MAX
              for v in shares.values()),
          f"bench: the corr row's roofline shares {util}")
    check(all(launched[k] > 0 for k in BENCH_KERNELS),
          f"bench: launches {launched}")
    print("bench rows: " + json.dumps({
        "card": card_line(), "peaks": util.get("peaks"),
        "rows": {k: {"ms": r[k], "median_ms": r[k + ":median"],
                     "device_ms": r[k + ":device_ms"]} for k in BENCH_ROWS},
        "util[fft_burst_100_ms[corr]]": util, "line": line,
        "seconds": time.perf_counter() - t0}), flush=True)
    return launched


def _flat_any(r) -> torch.Tensor:
    """Every tensor of a result (NamedTuples, tuples, parameter trees),
    flattened into one float64 vector."""
    out = []

    def walk(v):
        if torch.is_tensor(v):
            out.append(v.detach().reshape(-1).double())
        elif hasattr(v, "leaves"):
            for t in v.leaves():
                walk(t)
        elif hasattr(v, "_asdict"):
            for t in v._asdict().values():
                walk(t)
        elif dataclasses.is_dataclass(v):
            for fld in dataclasses.fields(v):
                walk(getattr(v, fld.name))
        elif isinstance(v, (tuple, list)):
            for t in v:
                walk(t)
    walk(r)
    return torch.cat(out)


# the kernels that must run on the tensor cores: the library's query of
# their attributes and its arguments for each instantiation (the leaf:
# real, complex, complex with bf16 out, each at three tiers)
TC_KERNELS = {"dft_leaf_kernel": ("dft_leaf_attrs", [(v, t) for v in range(3)
                                                     for t in range(3)]),
              "ydft_sweep_kernel": ("ydft_sweep_attrs", [(t,) for t in
                                                         range(3)]),
              # K5 (kind 0), K7 (1) and K6 (2); K8 (3), float32 and bf16
              # operands, D = 1..4 channels
              "tc_sweep_kernel": ("omega_tc_attrs", [
                  (k, b, d) for k in range(3) for b in range(2)
                  for d in range(1, 5)]),
              "tc_itergrid_kernel": ("omega_tc_attrs", [
                  (3, b, d) for b in range(2) for d in range(1, 5)])}


def tensor_core_proof(build) -> dict:
    """The HGMMA (wgmma) instructions in each instantiation of the
    tensor-core kernels (the two matmul DFTs, the sweep of K5-K7, K8), from
    ``cuobjdump -sass`` of the built library, and
    each instantiation's registers, local (spilled) bytes and shared memory
    as the runtime reports them (``cudaFuncGetAttributes``; the dynamic
    shared memory is what its launch asks for); fails if a kernel has no
    HGMMA.  Returns the counts by kernel name."""
    from spectralae_torch import _kernels
    tool = Path(_kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.path)],
                          capture_output=True, text=True, check=True).stdout
    hgmma = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if any(k in name for k in TC_KERNELS):
            hgmma[name] = sum("HGMMA" in line for line in chunk.splitlines())
    for name, count in sorted(hgmma.items()):
        print(f"tensor cores: {name}: {count} HGMMA instructions", flush=True)
    for kernel, (query, instances) in TC_KERNELS.items():
        got = {n: c for n, c in hgmma.items() if kernel in n}
        check(len(got) == len(instances) and all(c > 0 for c in
                                                 got.values()),
              f"{kernel}: HGMMA counts {got}")
        for args in instances:
            out = (ctypes.c_int * 4)()
            _kernels.check(getattr(build.lib, query)(*args, out), query)
            print(f"tensor cores: {kernel}{list(args)}: {out[0]} registers, "
                  f"{out[1]} local bytes, {out[2]} B static and "
                  f"{out[3] // 1024} KB dynamic shared memory", flush=True)
    return hgmma


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from spectralae_torch import _kernels
    from spectralae_torch.ops import fft_kernels as fk

    # 1. device
    print(card_line(), flush=True)
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
    hgmma = tensor_core_proof(build)

    # 3. kernels against their plain versions; forwards and train steps;
    # 3b. the window kernels, the four-step rfft2; 3c. the bursts
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed, errs = phase_kernels(gen)
    phase_forward()
    step = per_step(timed, phase_train_step())
    # 3a. the probe kernels, through their scripts
    probe_rows, perrs, probe_paths = phase_probes()
    errs.update(perrs)
    windows, werrs = phase_windows(gen)
    errs.update(werrs)
    fft_rows, ferrs = phase_fft(gen)
    rec_rows, rerrs, rec_launched = phase_fft_recursion(gen)
    errs.update(ferrs, **rerrs)
    mixed = phase_windows_mixed(gen)
    errs["k4"] = max(errs["k4"], *(r["abs"] for r in mixed.values()))
    phase_bursts(gen)
    # 3d. the omega-space burst engines
    (omega_rows, oerrs, omega_rels, omega_paths,
     omega_timing) = phase_omega(gen)
    errs.update(oerrs)

    # 4. the serving path; 5. the training path; 6. stream and burst
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        by_path = {"serve": phase_serving(tmp, gen)}
        by_path["train"], per_step_seen = phase_training(tmp)
        by_path["train_bf16"], seen_bf16 = phase_training_bf16(tmp)
        per_step_seen["k1bf"] = seen_bf16["k1bf"]
        check(seen_bf16["k2"] == per_step_seen["k2"],
              f"coord --bf16 launched K2 {seen_bf16['k2']}x a step")
        phase_train_vs_cpu(tmp)
        (by_path["stream"], by_path["stream_fft"],
         by_path["burst"]) = phase_stream_training(tmp)
        phase_stream_vs_cpu()
        # 7. the interactive loop, the coord stream, eval
        by_path["run"], by_path["stream_coord"] = phase_engine(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # 8. distributed training: K4's row slabs, NCCL at world size 1, two
    # gloo ranks on the card
    slab_rows, by_path["dist"], slab_err = phase_dist(gen)
    errs["k4"] = max(errs["k4"], slab_err)
    # 9. the benchmark harness, short
    by_path["bench"] = phase_bench()
    by_path.update(omega_paths)
    by_path.update(probe_paths)
    # every kernel that a path runs was launched in that path's run
    uses = {"serve": ("k1", "k2", "rs"), "train": ("k1", "k2", "rs"),
            "train_bf16": ("k1bf", "k2", "rs"),
            "probe_mosaic": tuple(k for k, _, _ in P1_ROWS),
            "probe_dft": ("p2",),
            "stream": ("k1", "k4", "rs"),
            "stream_fft": ("k4", "b5a", "b5b", "rs"),
            "burst": ("k1", "k3", "rs"), "omega_pallas": ("k5", "k6"),
            "run": ("k1", "k2", "k3", "rs"), "stream_coord": ("k2",),
            "omega_fused": ("k5", "k7"), "omega_itergrid": ("k8",),
            "dist": ("k1", "k2", "k3", "k4", "k5", "k7", "rs"),
            "bench": BENCH_KERNELS}
    for path, keys in uses.items():
        check(all(by_path[path][k] > 0 for k in keys),
              f"launches on the {path} path: {by_path[path]}")

    kernels = []
    for key, name, source, replaces in (
            ("k1", "cmul_contract", "spectralae_torch/csrc/cmul_contract.cu",
             "spectralae/ops/pallas_kernels.py:48"),
            ("k1bf", "cmul_contract_bf16",
             "spectralae_torch/csrc/cmul_contract.cu",
             "spectralae/ops/pallas_kernels.py:48"),
            ("k2", "conv_valid", "spectralae_torch/csrc/conv_valid.cu",
             "spectralae/ops/pallas_conv.py:110"),
            ("rs", "spectral_resize",
             "spectralae_torch/csrc/spectral_resize.cu",
             "none: XLA's gathers (spectralae/ops/spectral.py "
             "spectral_resize)"),
            ("k3", "corr_pair_windows",
             "spectralae_torch/csrc/corr_windows.cu",
             "spectralae/ops/pallas_windows.py:125"),
            ("k4", "anchor_windows", "spectralae_torch/csrc/corr_windows.cu",
             "spectralae/ops/pallas_windows.py:295")):
        paths = {path: by_path[path][key] for path in by_path}
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": sum(paths.values()),
               "launches_by_path": paths, "max_abs_err": errs[key]}
        if key in step:
            s = step[key]
            row.update({
                "ms": s["ms"], "ms_source": s["ms_source"],
                "plain_ms": s["plain_ms"],
                "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                "library_ms": s["library_ms"],
                "per": "one 256x256 batch-8 train step of the 3-pair net"
                       + (" with bf16 operands (--bf16)" if key == "k1bf"
                          else ""),
                "launches_per_step": per_step_seen[key],
                "fwd_ms": s["fwd_ms"], "fwd_plain_ms": s["fwd_plain_ms"],
                "bwd_ms": s["bwd_ms"], "bwd_plain_ms": s["bwd_plain_ms"]})
            if key == "rs":
                # every launch of a fft step at each size, the benchmark's
                # included, and the host's cost a call
                row["by_step"] = timed["rs_steps"]
                row["host_us"] = timed["rs_host_us"]
        else:
            variants = ("xx", "eg") if key == "k3" else ("f32",)
            rs = [windows[(key, 256, v)] for v in variants]
            row.update({
                name_: sum(r[name_] for r in rs)
                for name_ in ("ms", "plain_ms", "bound_ms")})
            row["bound_by"] = max(rs, key=lambda r: r["bound_ms"])[
                "bound_by"]
            row["ms_source"] = _sources(rs)
            row["library_ms"] = (sum(r["library_ms"] for r in rs)
                                 if key == "k3" else None)
            # the windows of 255-scale frames reach ~1e17: the absolute
            # error is read beside the norm-relative one
            row["max_norm_rel_err"] = max(
                r["rel"] for k, r in windows.items() if k[0] == key)
            row["per"] = (("the two launches of one burst precompute"
                           if key == "k3" else "one launch (one stream "
                           "frame)") + " at 256x256 batch-8 frames (pair "
                          "0's input, 128x128)")
            row["by_frame_size"] = {
                str(size): {v: {k: windows[(key, size, v)][k]
                                for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms")}
                            for v in (("xx", "eg") if key == "k3"
                                      else ("f32", "bf16"))}
                for size, _ in WINDOW_SIZES}
            if key == "k4":
                # the row_slab mode (the TP precompute): each cover's
                # slabs, device ms beside the full call's
                row["row_slab"] = {
                    f"{size} {v}": {"full_ms": r["full_ms"], **{
                        cover: [{k: sl[k] for k in (
                            "row0", "live", "ms", "plain_ms", "bound_ms",
                            "bound_by")} for sl in c["slabs"]]
                        for cover, c in r["covers"].items()}}
                    for (size, v), r in slab_rows.items()}
                # on the four-step FFT's mixed planes (the stream_fft path)
                for size, _ in WINDOW_SIZES:
                    row["by_frame_size"][str(size)].update({
                        f"mixed_{v}": {k: mixed[(size, v)][k]
                                       for k in ("ms", "plain_ms",
                                                 "bound_ms", "library_ms",
                                                 "gather_ms")}
                        for v in ("f32", "bf16")})
        kernels.append(row)
    timing = ("ms", "ms_source", "plain_ms", "bound_ms", "library_ms")
    for key, name, replaces in B5_ROWS:
        paths = {path: by_path[path][key] for path in by_path}
        row = {"name": name, "route": "cuda",
               "source": "spectralae_torch/csrc/rfft2_mixed.cu",
               "replaces": replaces, "launches": sum(paths.values()),
               "launches_by_path": paths, "max_abs_err": errs[key]}
        tiered = timing + ("vs_cufft",)
        if key in ("b5a", "b5b"):
            # the main path's tier: the --pallas-fft route's float32 planes
            tier_key = (ROUTE_TIER["fft"],) + (("f32",) if key == "b5b"
                                                else ())
            r = fft_rows[(key, 256) + tier_key]
            row.update({k: r[k] for k in timing + ("bound_by",)})
            row["tier"] = ROUTE_TIER["fft"]
            # bf16 out is held against the plain float32 planes: its
            # absolute error is the storage rounding of ~1e7-scale bins
            row["max_norm_rel_err_f32"] = max(
                v["rel"] for k, v in fft_rows.items()
                if k[0] == key and k[-1] != "bf16")
            row["per"] = ("one launch (one stream frame) at 256x256 batch-8 "
                          "frames (pair 0's 128x128 input, D=3)")
            variants = ("f32", "bf16") if key == "b5b" else (None,)
            row["by_frame_size"] = {
                str(size): {prec + (f" {v} out" if v else ""): {
                    k: fft_rows[(key, size, prec) + ((v,) if v else ())][k]
                    for k in tiered} for prec in fk.TIERS for v in variants}
                for size, _ in WINDOW_SIZES}
            if key == "b5b":
                row["transform_by_frame_size"] = {
                    str(size): {f"{k[2]} {k[3]} out": {
                        n: fft_rows[k][n] for n in timing + ("vs_cufft",)}
                        for k in fft_rows if k[:2] == ("rfft2", size)}
                    for size, _ in WINDOW_SIZES}
                row["transform_4096"] = rec_rows["rfft2_4096"]
        else:
            r = rec_rows[key]
            if key == "b5e":
                row["by_tier"] = {prec: {k: r[prec][k] for k in tiered}
                                  for prec in fk.TIERS}
                r = r[ROUTE_TIER["fft"]]
                row["tier"] = ROUTE_TIER["fft"]
            row.update({k: r[k] for k in timing + ("bound_by",)})
            row["per"] = (f"one launch in the [3, {RECURSION_N}, "
                          f"{RECURSION_N}] transform (8192^2 frames' pair-0 "
                          "input); the main path at 256^2 runs none")
            row["launches_recursion_run"] = rec_launched[key]
        if key in ("b5a", "b5b", "b5e"):
            row["hgmma"] = {n: c for n, c in hgmma.items()
                            if "dft_leaf_kernel" in n}
        kernels.append(row)
    head = "256x256 b1 (headline)"
    for key, name, replaces in OMEGA_ROWS:
        paths = {path: by_path[path][key] for path in by_path}
        r = omega_rows[(head, key, "f32")]
        row = {"name": name, "route": "cuda",
               "source": "spectralae_torch/csrc/omega_burst.cu",
               "replaces": replaces, "launches": sum(paths.values()),
               "launches_by_path": paths, "max_abs_err": errs[key],
               **{k: r[k] for k in timing + ("bound_by",)},
               # the largest of the outputs held one by one, both inputs
               # and operand types
               "max_norm_rel_err": omega_rels[key],
               "per": ("one launch at the JAX benchmark's headline input (one "
                       "[3, 256, 256] frame, pair 0 of the default net, "
                       "float32 operands)" + (
                           f", a {STREAM_CMP_ITERS}-iteration burst"
                           if key == "k8" else "")),
               "by_input": {}}
        for k, v in omega_rows.items():
            if k[1] == key:
                row["by_input"].setdefault(k[0], {})[k[2]] = {
                    n: v[n] for n in timing}
        if key == "k8":
            row["device_ms_100_iteration_burst"] = omega_timing[
                (head, "omega_itergrid")]["device_ms"]
        grid = "tc_itergrid_kernel" if key == "k8" else "tc_sweep_kernel"
        row["hgmma"] = {n: c for n, c in hgmma.items() if grid in n}
        kernels.append(row)
    for key, name, replaces in P1_ROWS + (
            ("p2", "ydft_energy", "scripts/probe_fused_dft.py:75"),):
        paths = {path: by_path[path][key] for path in by_path}
        r = probe_rows[key]
        extra = {"per": "one launch on the JAX probe's input"}
        if key == "p2":
            # the probe script's default tier
            extra = {
                "tier": "default",
                "by_tier": {prec: {k: r[prec][k] for k in timing + (
                    "vs_ref",)} for prec in fk.TIERS},
                "hgmma": {n: c for n, c in hgmma.items()
                          if "ydft_sweep_kernel" in n},
                "per": f"one launch (two grids) at [3, {P2_N}, {P2_N}]; "
                       "library: torch.fft.rfft and the weighted sum"}
            r = r["default"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "spectralae_torch/csrc/probes.cu",
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths, "max_abs_err": errs[key],
            **{k: r[k] for k in timing + ("bound_by",)},
            "max_norm_rel_err": r["rel"], **extra})
    print(f"the device profiles held {PROFILED['held']} of the "
          f"{PROFILED['expected']} operation records they should have",
          flush=True)
    print(json.dumps({"kernels": kernels, "omega_bursts_100": {
        f"{label}: {name}": v for (label, name), v in omega_timing.items()}}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
