"""Run one cell of the port's benchmark on the card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones (a slice of steps under the
profiler after the window).  The last line of standard output is the
result, a JSON object; the last lines of standard error give each number
compared with its limit.  Without as many CUDA devices as the cell asks
for, it prints no result and exits 2; it never falls back to the CPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    cell = harness.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch finds {have}: no result", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace),
                         device=torch.device("cuda", 0), t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
