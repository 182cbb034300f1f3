"""The box volumes of a box cell's solves, on the card.

    python3 cme_bench/boxes.py --workload <name> --seeds 11,12,13

For each seed it runs solves 0 .. 100 of the cell's draws through the
harness's gated solve and prints one JSON line: per solve the largest
box its segments ran on, its final box, nstep, nmult, wsum and the fault
(the gate's, or what the solve raised, such as the OverflowError at
``max_box_volume``); then the largest box of the seed beside
``max_box_volume``.  A box at most half the cap never had a growth
refused by it.  The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: the draws solved for each seed
SOLVES = range(0, 101)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch

    from cme_bench import harness
    from krylovfspssa_tpu_torch import boxsolver

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    c = harness.cell(args.workload)
    if c.traffic["entry"] != "box":
        print(f"{c.name} does not run the box", file=sys.stderr)
        return 2
    volumes = []
    real = boxsolver.BoxCmeSolver._advance

    def advance(self, box, growable):  # every box a segment runs on
        volumes.append(int(box.volume))
        return real(self, box, growable)

    boxsolver.BoxCmeSolver._advance = advance
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(report(c, seed, volumes)), flush=True)
    finally:
        boxsolver.BoxCmeSolver._advance = real
    return 0


def report(c, seed: int, volumes: list) -> dict:
    """Solve the seed's draws; ``volumes`` collects the boxes of the
    solve in progress."""
    from cme_bench import harness
    from krylovfspssa_tpu_torch import SolverConfig

    model = c.config.model()
    rows = []
    for i in SOLVES:
        volumes.clear()
        sv = harness.run_solve(c, model, seed, i, "cuda")
        rows.append({"i": i, "largest_box": max(volumes, default=0),
                     "box": sv.counts.get("box"),
                     "nstep": sv.counts.get("nstep"),
                     "nmult": sv.counts.get("nmult"),
                     "wsum": sv.counts.get("wsum"),
                     "wall_s": sv.wall, "fault": sv.fault})
    wsums = [r["wsum"] for r in rows if r["wsum"] is not None]
    return {
        "workload": c.name, "seed": seed,
        "max_box_volume": SolverConfig().max_box_volume,
        "largest_box": max(r["largest_box"] for r in rows),
        "final_below_largest": sum(r["box"] is not None
                                   and r["box"] < r["largest_box"]
                                   for r in rows),
        "faults": [(r["i"], r["fault"]) for r in rows if r["fault"]],
        "wsum_range": [min(wsums, default=None), max(wsums, default=None)],
        "nstep_range": [min(r["nstep"] or 0 for r in rows),
                        max(r["nstep"] or 0 for r in rows)],
        "solves": rows}


if __name__ == "__main__":
    sys.exit(main())
