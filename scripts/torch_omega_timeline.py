#!/usr/bin/env python3
"""Where a launch of K5-K8 (the tensor-core sweep) spends its time.

Builds a copy of ``spectralae_torch`` under ``build/omega_timeline/`` whose
``omega_burst.cu`` stamps the card's ``%globaltimer`` (ns) at the seams of
each tile's work and, in K8, of each iteration, runs the kernels at
``chip_smoke.py``'s two burst inputs (the headline, one [3, 256, 256]
frame; the stream's pair-0 input, 128² b8) with float32 operands, and
prints per tile phase (means and maxima over the tiles, µs): the setup
(first frame's planes, basis copies, compact kernels' pieces) and the
spectra rebuild; the per-bin pass; staging the projection's operand and
the MSE sum; the projection and the tile's partial.  K7 and K5 (and K6,
which has no projection): then the fixed-order sum (for the blocks that
take a group's last ticket: the ticket's fences, then the group's
records), the launch's span, when the last block started, when the last
partial was written, and the tail after it.  K8 (a 100-iteration burst):
the tile phases over every iteration, then per iteration (means over the
iterations of the mean and the largest block) the inertia update, the
block's tiles, the wait at the first grid barrier, the group sums, the
second barrier, the groups' sums, the third barrier, and the iteration's
span.  The stamps cost a few instructions a tile; the timer ticks in steps
of a few hundred ns on some cards, so read means, not single tiles.
Prints the card's name and power limit first::

    python scripts/torch_omega_timeline.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "omega_timeline"
K8_ITERS = 100
MAX_TILES, MAX_BLOCKS, IT_BASE = 1024, 512, 1 << 20   # stamp slots

STAMP = f'''__shared__ int s_stamp_it;          // K8's iteration; 0 in K5-K7
__device__ unsigned long long g_stamps[{2 * IT_BASE}];
__device__ __forceinline__ unsigned long long now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
// the seams of one tile's work, and of one iteration of K8 a block
__device__ __forceinline__ void stamp(int tile, int k) {{
  if (threadIdx.x == 0)
    g_stamps[((size_t)s_stamp_it * {MAX_TILES} + tile) * 8 + k] = now();
}}
__device__ __forceinline__ void stamp_it(int k) {{
  if (threadIdx.x == 0)
    g_stamps[{IT_BASE} + ((size_t)s_stamp_it * {MAX_BLOCKS} + blockIdx.x) * 8
             + k] = now();
}}

'''
READ = '''
extern "C" int omega_stamps(void* dst, long long n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n * 8);
}
extern "C" int omega_stamps_clear() {
  void* p = nullptr;
  const int err = (int)cudaGetSymbolAddress(&p, g_stamps);
  return err ? err : (int)cudaMemset(p, 0, sizeof(g_stamps));
}
'''
# (anchor in csrc/omega_burst.cu, the text that replaces it)
EDITS = [
    ("// After the block's stores", STAMP + "// After the block's stores"),
    ("  Frame first;\n  load_frame<MODE, D>",
     "  stamp(tile, 0);\n  Frame first;\n  load_frame<MODE, D>"),
    ("  const float v = tc_bin_pass<MODE, D>(",
     "  stamp(tile, 1);\n  const float v = tc_bin_pass<MODE, D>("),
    ("  if constexpr (T::PROJECT) {\n    if (project) tc_stage_a",
     "  stamp(tile, 2);\n  if constexpr (T::PROJECT) {\n"
     "    if (project) tc_stage_a"),
    ("  // the projection, fresh for this tile",
     "  stamp(tile, 3);\n  // the projection, fresh for this tile"),
    ("    if (t == 0) rec[n] = s.red[0] / (float)a.nb;\n    return;",
     "    if (t == 0) rec[n] = s.red[0] / (float)a.nb;\n"
     "    stamp(tile, 4);\n    return;"),
    ("  if (t == 0) rec[n] = s.red[0] / (float)a.nb;\n}\n",
     "  if (t == 0) rec[n] = s.red[0] / (float)a.nb;\n  stamp(tile, 4);\n}\n"),
    ("  const int nrec = T::PROJECT ? a.rows * a.P + 1 : 1;\n",
     "  const int nrec = T::PROJECT ? a.rows * a.P + 1 : 1;\n"
     "  if (threadIdx.x == 0) s_stamp_it = 0;\n"),
    ("                          a.ntiles, s.flag, s.red);\n",
     "                          a.ntiles, s.flag, s.red);\n"
     "  stamp(blockIdx.x, 5);\n"),
    ("  if (!ticket(tickets + g, t1 - t0, flag)) return;\n",
     "  if (!ticket(tickets + g, t1 - t0, flag)) return;\n"
     "  stamp(blockIdx.x, 6);\n"),
    ("  if (!ticket(tickets + ng, ng, flag)) return;",
     "  __syncthreads();\n  stamp(blockIdx.x, 7);\n"
     "  if (!ticket(tickets + ng, ng, flag)) return;"),
    ("    if (it) {  // inertia",
     "    if (threadIdx.x == 0) s_stamp_it = it;\n    stamp_it(0);\n"
     "    if (it) {  // inertia"),
    ("    const bool project = it < iters;\n",
     "    stamp_it(1);\n    const bool project = it < iters;\n"),
    ("    grid.sync();\n    // level 1",
     "    stamp_it(2);\n    grid.sync();\n    stamp_it(3);\n    // level 1"),
    ("    grid.sync();\n    // level 2",
     "    stamp_it(4);\n    grid.sync();\n    stamp_it(5);\n    // level 2"),
    ("    if (!project) break;\n",
     "    stamp_it(6);\n    if (!project) break;\n"),
    ("gsum[n + o] = __ldcg(dbdp + o);\n    grid.sync();\n",
     "gsum[n + o] = __ldcg(dbdp + o);\n    grid.sync();\n    stamp_it(7);\n"),
]


def instrumented() -> Path:
    """The stamped copy of the package (rebuilt from this checkout)."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "spectralae_torch", COPY / "spectralae_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = COPY / "spectralae_torch" / "csrc" / "omega_burst.cu"
    text = src.read_text()
    for anchor, new in EDITS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"omega_burst.cu: anchor not found once: "
                               f"{anchor!r}")
        text = text.replace(anchor, new)
    src.write_text(text + READ)
    return COPY


def stamps(lib, call, n: int, warm: int = 4) -> torch.Tensor:
    """The stamp slots [0, n) of one call after warm-up, µs from the first
    nonzero stamp (0 where none was set), as float64."""
    for _ in range(warm):
        call()
    torch.cuda.synchronize()
    if lib.omega_stamps_clear():
        raise RuntimeError("omega_stamps_clear failed")
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    raw = torch.empty(n, dtype=torch.int64)
    if lib.omega_stamps(ctypes.c_void_p(raw.data_ptr()), ctypes.c_longlong(n)):
        raise RuntimeError("omega_stamps failed")
    set_ = raw > 0
    us = (raw - raw[set_].min()).double() / 1e3     # exact before the cast
    return torch.where(set_, us, torch.zeros_like(us))


def _mm(x: torch.Tensor) -> tuple[float, float]:
    return (float(x.mean()), float(x.max())) if x.numel() else (0.0, 0.0)


def tile_phases(T: torch.Tensor, project: bool) -> dict:
    """Per-tile phases from tile stamps [tiles, 8]."""
    if project:
        names = ("setup and rebuild", "per-bin pass", "stage and MSE sum",
                 "projection and partial")
        seams = (0, 1, 2, 3, 4)
    else:
        names = ("setup and rebuild", "per-bin pass", "MSE sum")
        seams = (0, 1, 2, 4)
    return {n: _mm(T[:, seams[i + 1]] - T[:, seams[i]])
            for i, n in enumerate(names)}


def report_sweep(label: str, T: torch.Tensor, project: bool) -> dict:
    """One launch of K5, K6 or K7: stamps [ntiles, 8]."""
    row = tile_phases(T, project)
    row["fixed-order sum"] = _mm(T[:, 5] - T[:, 4])
    last = T[:, 6] > 0
    row["group ticket"] = _mm(T[last, 6] - T[last, 4])
    row["group sum"] = _mm(T[last, 7] - T[last, 6])
    span, last_start = float(T[:, 5].max()), float(T[:, 0].max())
    last_partial = float(T[:, 4].max())
    print(f"{label}: span {span:.2f} us, last block started at "
          f"{last_start:.2f}, last partial written at {last_partial:.2f}, "
          f"tail {span - last_partial:.2f}; per tile (mean / max us): "
          + "; ".join(f"{n} {m:.2f} / {x:.2f}" for n, (m, x) in row.items()),
          flush=True)
    return {"span_us": span, "last_start_us": last_start,
            "tail_us": span - last_partial, "phases_us": row}


def report_itergrid(label: str, raw: torch.Tensor, ntiles: int,
                    blocks: int, iters: int) -> dict:
    """One K8 burst: tile stamps [iters+1, MAX_TILES, 8], iteration stamps
    [iters+1, MAX_BLOCKS, 8]."""
    tiles = raw[:IT_BASE].reshape(-1, MAX_TILES, 8)[:iters + 1, :ntiles]
    its = raw[IT_BASE:].reshape(-1, MAX_BLOCKS, 8)[:iters + 1, :blocks]
    row = tile_phases(tiles[:iters].reshape(-1, 8), True)
    names = ("update", "tiles", "barrier 1", "group sums", "barrier 2",
             "groups' sums", "barrier 3")
    mid = its[1:iters]          # iterations with an update and a projection
    per_it = {}
    for i, n in enumerate(names):
        d = mid[..., i + 1] - mid[..., i]           # [iterations, blocks]
        per_it[n] = (float(d.mean()), float(d.max(1).values.mean()))
    span = its[1:iters, :, 7].max(1).values - its[1:iters, :, 0].min(1).values
    burst = float(its[iters, :, 6].max() - its[0, :, 0].min())
    print(f"{label}: {blocks} blocks, burst {burst:.2f} us, an iteration "
          f"{float(span.mean()):.2f} us (mean of {iters - 1}); per tile over "
          f"the burst (mean / max us): "
          + "; ".join(f"{n} {m:.2f} / {x:.2f}" for n, (m, x) in row.items())
          + "; per iteration (block mean / slowest block, us): "
          + "; ".join(f"{n} {m:.2f} / {x:.2f}"
                      for n, (m, x) in per_it.items()), flush=True)
    return {"burst_us": burst, "iteration_us": float(span.mean()),
            "tile_phases_us": row, "iteration_phases_us": per_it}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(instrumented()))
    import chip_smoke as cs
    from spectralae_torch import _kernels
    from spectralae_torch.ops import burst_kernels as bk
    from spectralae_torch.train import fft_pallas as fp
    if not Path(bk.__file__).is_relative_to(COPY):
        raise RuntimeError(f"imported {bk.__file__}, not the stamped copy")
    lib = _kernels.lib()
    lib.omega_stamps.argtypes = (ctypes.c_void_p, ctypes.c_longlong)
    lib.omega_stamps_clear.argtypes = ()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, x, out0, w in cs._omega_inputs(gen):
        s = fp._prepare(x, x, out0, w[0], True, torch.float32)
        M, D, nk, _ = w[0].shape
        cf = fp._stack(w[0], w[1], M * D, nk * nk)
        ops = (s.planes, s.basis, s.wv, cf, w[2])
        k = dict(s.consts)
        k6 = {n: k[n] for n in ("norm", "inv_m", "inv_d")}
        ntiles = -(-s.planes.shape[-1] // bk.TC_TILE)
        if ntiles > MAX_TILES:
            raise RuntimeError(f"{ntiles} tiles: more than {MAX_TILES}")
        calls = {
            "K7": (lambda: bk.fused_step(*ops, w[3], **k), True),
            "K5": (lambda: bk.grad_project(*ops, norm=k["norm"],
                                           scale=k["scale"]), True),
            "K6": (lambda: bk.respectra_conv(*ops, w[3], **k6), False)}
        for name, (call, project) in calls.items():
            T = stamps(lib, call, ntiles * 8).reshape(ntiles, 8)
            report_sweep(f"{name} {label}, {ntiles} tiles", T, project)
        zeros = [torch.zeros_like(t) for t in (cf, w[2], w[3])]
        raw = stamps(lib, lambda: bk.itergrid(
            *ops, w[3], *zeros, iters=K8_ITERS, lr_eff=0.02, alpha=0.9, **k),
            2 * IT_BASE, warm=1)
        # the grid K8 ran: the blocks that stamped iteration 0
        its = raw[IT_BASE:].reshape(-1, MAX_BLOCKS, 8)
        blocks = int((its[0, :, 1] > 0).sum())
        report_itergrid(f"K8 {label}, {ntiles} tiles, {K8_ITERS} iterations "
                        f"({sms} SMs)", raw, ntiles, blocks, K8_ITERS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
