"""Readings that the comparison limits of a cell are set from, on the card.

    python3 cme_bench/readings.py --workload <name> --seeds 11,12,13
        [--program-dtype float32] [--reference-dtype float32]

For each seed it runs the solves a run compares (solves 1 .. sample of
the cell's ``workloads/<cell>.json``) at the cell's own size and prints
one JSON line: each answer's excess over the float64 reference.  With
``--program-dtype float32`` the program runs its own float32 path (a
control); with ``--reference-dtype float32`` the plain reference,
computed in float32, stands in the program's place (the other control).
A solve that raises is reported as such (a control that raises has
failed and gives no number); the rest are compared.  The benchmark's own
runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program-dtype", default=None)
    ap.add_argument("--reference-dtype", default=None)
    args = ap.parse_args(argv)

    import torch

    from cme_bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    c = harness.cell(args.workload)
    n = int(c.limits["sample"])
    model = c.config.model() if args.reference_dtype is None else None
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": c.name, "seed": seed}
        params = [harness.parameters(c, seed, i)[0] for i in range(1, n + 1)]
        t0 = time.perf_counter()
        if args.reference_dtype:
            line["reference_dtype"] = args.reference_dtype
            sol = harness.reference(c, params, "cuda",
                                    getattr(torch, args.reference_dtype))
            answers = [(sol.states, sol.p[k]) for k in range(n)]
        else:
            line["program_dtype"] = args.program_dtype or c.config.DTYPE
            solves = [harness.run_solve(c, model, seed, i, "cuda",
                                        args.program_dtype)
                      for i in range(1, n + 1)]
            line["solves"] = [harness.solve_line(sv) for sv in solves]
            line["failed"] = [sv.fault for sv in solves if sv.fault]
            kept = [k for k, sv in enumerate(solves) if not sv.fault]
            params = [params[k] for k in kept]
            answers = [(solves[k].states, solves[k].probabilities)
                       for k in kept]
        line["program_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if answers:
            line["excess"] = harness.excesses(c, params, answers, "cuda")
            line["max_excess"] = max(line["excess"])
        line["reference_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
