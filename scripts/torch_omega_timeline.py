#!/usr/bin/env python3
"""Where a launch of K5 or K7 (the tensor-core sweep) spends its time.

Builds a copy of ``spectralae_torch`` under ``build/omega_timeline/`` whose
``tc_sweep_kernel`` stamps the card's ``%globaltimer`` (ns) at the seams of
each block's work, runs K7 and K5 at ``chip_smoke.py``'s two burst inputs
(the headline, one [3, 256, 256] frame; the stream's pair-0 input, 128² b8)
with float32 operands, and prints per block phase (means and maxima over
the blocks, µs): the setup (first frame's planes, basis copies, compact
kernels' pieces) and the spectra rebuild; the per-bin pass; staging the
projection's operand and the MSE sum; the projection and the tile's
partial; the fixed-order sum (for the blocks that take a group's last
ticket: the ticket's fences, then the group's records).  Then the launch's
span, when the last block started, when the last partial was written, and
the tail after it.  The stamps cost a few instructions a block; the timer
ticks in steps of a few hundred ns on some cards, so read means, not
single blocks.  Prints the card's name and power limit first::

    python scripts/torch_omega_timeline.py
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "omega_timeline"

STAMP = '''__device__ __forceinline__ void stamp(unsigned* tickets, int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    reinterpret_cast<unsigned long long*>(tickets + 4096)[blockIdx.x * 8 + k] =
        t;
  }
}

'''
# (anchor in csrc/omega_burst.cu, the text that replaces it)
EDITS = [
    ("// After the block's stores", STAMP + "// After the block's stores"),
    ("  Frame first;\n  load_frame<MODE, D>",
     "  stamp(tickets, 0);\n  Frame first;\n  load_frame<MODE, D>"),
    ("  const float v = tc_bin_pass<MODE, D>(",
     "  stamp(tickets, 1);\n  const float v = tc_bin_pass<MODE, D>("),
    ("  tc_stage_a<PP>(", "  stamp(tickets, 2);\n  tc_stage_a<PP>("),
    ("  // the projection, fresh for this tile",
     "  stamp(tickets, 3);\n  // the projection, fresh for this tile"),
    ("  tc_combine(part, gpart, tickets, out, n + 1, n, a.scale, a.ntiles, "
     "flag);",
     "  stamp(tickets, 4);\n  tc_combine(part, gpart, tickets, out, n + 1, "
     "n, a.scale, a.ntiles, flag);\n  stamp(tickets, 5);"),
    ("  if (!ticket(tickets + g, t1 - t0, flag)) return;\n",
     "  if (!ticket(tickets + g, t1 - t0, flag)) return;\n"
     "  stamp(tickets, 6);\n"),
    ("  if (!ticket(tickets + ng, ng, flag)) return;",
     "  __syncthreads();\n  stamp(tickets, 7);\n"
     "  if (!ticket(tickets + ng, ng, flag)) return;"),
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
    src.write_text(text)
    ops = COPY / "spectralae_torch" / "ops" / "burst_kernels.py"
    text = ops.read_text()
    anchor = "torch.zeros(max(n, 1024),"
    if text.count(anchor) != 1:
        raise RuntimeError("burst_kernels.py: the tickets' allocation moved")
    ops.write_text(text.replace(anchor, "torch.zeros(max(n, 1 << 20),"))
    return COPY


def timeline(bk, tickets_of, call, ntiles) -> dict:
    """Stamps of one launch after warm-up, µs from the first block's start
    ([ntiles, 8]; 0 where a block set none)."""
    for _ in range(4):
        call()
    torch.cuda.synchronize()
    tickets = tickets_of()
    tickets[4096:].zero_()
    call()
    torch.cuda.synchronize()
    raw = (tickets[4096:4096 + 16 * ntiles].view(torch.int64)
           .reshape(ntiles, 8).cpu().double())
    base = raw[:, 0].min()
    return torch.where(raw > 0, (raw - base) / 1e3, torch.zeros_like(raw))


def report(label: str, T: torch.Tensor) -> dict:
    names = ("setup and rebuild", "per-bin pass", "stage and MSE sum",
             "projection and partial", "fixed-order sum")
    d = T[:, 1:6] - T[:, :5]
    last = T[:, 6] > 0
    row = {n: (float(d[:, i].mean()), float(d[:, i].max()))
           for i, n in enumerate(names)}
    row["group ticket"] = (float((T[last, 6] - T[last, 4]).mean()),
                           float((T[last, 6] - T[last, 4]).max()))
    row["group sum"] = (float((T[last, 7] - T[last, 6]).mean()),
                        float((T[last, 7] - T[last, 6]).max()))
    span, last_start = float(T[:, 5].max()), float(T[:, 0].max())
    last_partial = float(T[:, 4].max())
    print(f"{label}: span {span:.2f} us, last block started at "
          f"{last_start:.2f}, last partial written at {last_partial:.2f}, "
          f"tail {span - last_partial:.2f}; per block (mean / max us): "
          + "; ".join(f"{n} {m:.2f} / {x:.2f}" for n, (m, x) in row.items()),
          flush=True)
    return {"span_us": span, "last_start_us": last_start,
            "tail_us": span - last_partial, "phases_us": row}


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
    from spectralae_torch.ops import burst_kernels as bk
    from spectralae_torch.train import fft_pallas as fp
    if not Path(bk.__file__).is_relative_to(COPY):
        raise RuntimeError(f"imported {bk.__file__}, not the stamped copy")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, x, out0, w in cs._omega_inputs(gen):
        s = fp._prepare(x, x, out0, w[0], True, torch.float32)
        M, D, nk, _ = w[0].shape
        cf = fp._stack(w[0], w[1], M * D, nk * nk)
        ops = (s.planes, s.basis, s.wv, cf, w[2])
        k = dict(s.consts)
        ntiles = -(-s.planes.shape[-1] // bk.TC_TILE)
        calls = {
            "K7": lambda: bk.fused_step(*ops, w[3], **k),
            "K5": lambda: bk.grad_project(*ops, norm=k["norm"],
                                          scale=k["scale"])}
        key = (s.planes.device, torch.cuda.current_stream().cuda_stream)
        for name, call in calls.items():
            report(f"{name} {label}, {ntiles} tiles",
                   timeline(bk, lambda: bk._TICKETS[key], call,
                            ntiles))
    return 0


if __name__ == "__main__":
    sys.exit(main())
