"""Run one cell of the benchmark once, on the card.

    python3 cme_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, the CUDA context, the
first build of the program's kernels into the checkout's ``build/``, the
model, one warm-up solve) is timed from the start of this process; then
solves run back to back for ``--seconds``.  Each solve's wall and counts
print on a line of their own; the last line of standard output is the
result, a JSON object.  With ``--trace 1`` its metrics are the per-layer
ones, read from one profiled solve and one solve under spans after the
window.  The numbers compared with the plain reference print last on
standard error, and last in the result under ``checks``.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; it never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from cme_bench import harness

    c = harness.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {c.chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    result = harness.run(c, args.seed, args.seconds,
                         bool(args.trace), T_START,
                         log=lambda s: print(s, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
