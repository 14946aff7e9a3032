"""Readings for the limits of the tied, kernel-diverse cell, on the card.

    python3 scripts/torch_tied_limits.py --seeds 1 2 3 ... [--controls 3] \\
        [--workload m50k5tied.step-fft.1024-b16] [--out <file.jsonl>]

For each seed, in one process and at the cell's own size: the program's
first steps through the benchmark's own loop and entry
(``benchmark/entries/step_tied.py``), held step by step against the plain
float64 reference (``benchmark/reference/tied.py``), which gives the five
numbers a sound run reads.  For the first ``--controls`` seeds, the same
numbers for

- ``program_tf32``: the program with TF32 on for cuBLAS and cuDNN, the
  precision below the configuration's float32 with TF32 off;
- ``program_bf16``: the program's own reduced path (``--bf16``: bf16
  operands, float32 sums);
- ``reference_tf32``, ``reference_float32``: the reference itself in
  float32 with TF32 on and off;
- ``half_batch``: the reference on half of each batch (a fault a training
  step can have);
- ``no_diversity``: the program's step with ``w1 = 0``, the diversity term
  left out;
- ``bf16_diversity``: the program with the kernels' repulsion on bf16
  operands and its result rounded to bf16;
- ``untied``: the program's step with ``sym`` off while the reference
  ties (an untied decoder).

The faults are made at run time, in this process, by wrapping the
program's functions; no file changes.  One JSON line a seed and reading,
to standard output and to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _forcing(step, **forced):
    def broken(*args, **kw):
        return step(*args, **dict(kw, **forced))
    return broken


def program(cell: dict, inputs, patches=None, compute_dtype=None) -> dict:
    """The program's first steps as the cell's set-up takes them, with
    ``patches`` (``(module, name) -> value``) in place meanwhile."""
    import torch
    from benchmark.entries import step_tied
    patches = patches or {}
    saved = {k: getattr(*k) for k in patches}
    for (mod, name), value in patches.items():
        setattr(mod, name, value)
    try:
        n = cell["traffic"]["check_steps"]
        loop = step_tied.Loop(cell, inputs, n, compute_dtype)
        out = step_tied.check_steps(loop, inputs.leaves, n)
        del loop
    finally:
        for (mod, name), value in saved.items():
            setattr(mod, name, value)
    if inputs.leaves[0].is_cuda:
        torch.cuda.empty_cache()
    return out


def readings(cell: dict, seed: int, device, controls: bool) -> list[dict]:
    import torch
    from benchmark.entries import step, step_tied
    from benchmark.reference import tied as reference
    from spectralae_torch.losses import losses
    from spectralae_torch.train import modern
    traffic = cell["traffic"]
    inputs = step.Inputs(cell, seed, device)
    runs = {"program": program(cell, inputs)}
    if controls:
        tf32 = dict(cell, config=dict(cell["config"], tf32=True))
        runs["program_tf32"] = program(tf32, inputs)
        runs["program_bf16"] = program(cell, inputs,
                                       compute_dtype=torch.bfloat16)
        repulsion = losses.kernel_repulsion
        runs["no_diversity"] = program(cell, inputs, {
            (modern, "train_step"): _forcing(modern.train_step, w1=0.0)})
        runs["bf16_diversity"] = program(cell, inputs, {
            (losses, "kernel_repulsion"):
                lambda c: repulsion(c.bfloat16()).bfloat16().float()})
        runs["untied"] = program(cell, inputs, {
            (modern, "train_step"): _forcing(modern.train_step,
                                             sym=False)})
        batches = [inputs.pattern.batch_at(k)
                   for k in range(traffic["check_steps"])]

        def ref(xs, **how):
            return reference.train(inputs.leaves, xs, cell["config"],
                                   traffic["domain"],
                                   rows=traffic["reference_rows"], **how)
        runs["reference_tf32"] = ref(batches, dtype=torch.float32,
                                     tf32=True)
        runs["reference_float32"] = ref(batches, dtype=torch.float32)
        runs["half_batch"] = ref([b[: b.shape[0] // 2] for b in batches])
    out = []
    for name, r in runs.items():
        t = time.perf_counter()
        nums = step_tied.reference_readings(cell, inputs, r,
                                            traffic["check_steps"])
        out.append({"seed": seed, "reading": name, **nums,
                    "reference_s": time.perf_counter() - t})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="m50k5tied.step-fft.1024-b16")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    if args.device == "cuda" and not torch.cuda.is_available():
        print("tied limits: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        for row in readings(cell, seed, device, i < args.controls):
            line = json.dumps({"workload": args.workload, **row})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
