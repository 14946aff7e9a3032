"""Readings for a training cell's limits, at the cell's own size, on the card.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 ... \\
        [--controls 3]

For each seed, in one process: the program's first steps through the
window's own loop (:mod:`benchmark.entries.step`), held step by step
against the plain reference in float64 (the readings a sound run gives),
and for the first ``--controls`` seeds the same numbers for

- ``program_tf32``: the program with TF32 switched on for cuBLAS and
  cuDNN, the precision below the configuration's float32 with TF32 off;
- ``program_bf16``: the program's own reduced path (``--bf16``: bf16
  operands, float32 sums), the precision below other float32;
- ``reference_tf32``, ``reference_float32``: the reference itself in
  float32 with TF32 on and off;
- ``half_batch``: the reference on half of each batch, the mean taken over
  the rest (a fault a training step can have).

A state left unchanged reads 1 on ``grad_gap`` and ``update_gap`` by the
measure itself and needs no run.  One JSON line a seed and reading; the
harness's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def program_steps(cell: dict, inputs, **how) -> dict:
    """The program's first steps, as the harness's set-up takes them."""
    import torch
    from benchmark.entries import step
    n = cell["traffic"]["check_steps"]
    loop = step.Loop(cell, inputs, n, **how)
    out = step.check_steps(loop, inputs.leaves, n)
    del loop
    if inputs.leaves[0].is_cuda:
        torch.cuda.empty_cache()
    return out


def readings(cell: dict, seed: int, device, controls: bool) -> list[dict]:
    import torch
    from benchmark import compare
    from benchmark.entries import step
    from benchmark.reference import autoencoder as reference
    traffic = cell["traffic"]
    inputs = step.Inputs(cell, seed, device)
    runs = {"program": program_steps(cell, inputs)}
    if controls:
        tf32 = dict(cell, config=dict(cell["config"], tf32=True))
        runs["program_tf32"] = program_steps(tf32, inputs)
        runs["program_bf16"] = program_steps(cell, inputs,
                                             compute_dtype=torch.bfloat16)
    batches = [inputs.pattern.batch_at(k)
               for k in range(traffic["check_steps"])]

    def ref(xs, **how):
        return reference.train(inputs.leaves, xs, cell["config"],
                               traffic["domain"],
                               rows=traffic["reference_rows"], **how)
    if controls:
        runs["reference_tf32"] = ref(batches, dtype=torch.float32,
                                     tf32=True)
        runs["reference_float32"] = ref(batches, dtype=torch.float32)
        runs["half_batch"] = ref([b[: b.shape[0] // 2] for b in batches])
    out = []
    for name, r in runs.items():
        t = time.perf_counter()
        truth = reference.follow(r["params"][:len(batches)], batches,
                                 cell["config"], traffic["domain"],
                                 rows=traffic["reference_rows"])
        out.append({"seed": seed, "reading": name,
                    **compare.readings(r, truth),
                    "reference_s": time.perf_counter() - t})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        for row in readings(cell, seed, device, i < args.controls):
            print(json.dumps({"workload": args.workload, **row}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
