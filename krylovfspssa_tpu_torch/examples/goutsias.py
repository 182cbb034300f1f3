"""Goutsias transcription regulation model (6 species, 10 reactions).

Mirrors the reference ``examples/transcr6d.f90`` (program solve_goutsias):
x0 = (2, 6, 0, 2, 0, 0), t = 300, stiff rate constants spanning ten orders
of magnitude.  At the default t = 300 the box outgrows max_box_volume and
the solve raises OverflowError, as in the JAX package; t = 10 reaches the
2^22-cell box.

Run:  python -m krylovfspssa_tpu_torch.examples.goutsias [--t 300] [--device cuda]
"""

import argparse
import time

from krylovfspssa_tpu_torch.boxsolver import solve_cme_box
from krylovfspssa_tpu_torch.models.library import goutsias_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=float, default=300.0)
    ap.add_argument("--fsp-tol", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = goutsias_model()
    t0 = time.perf_counter()
    res = solve_cme_box(
        model, args.t, [[2, 6, 0, 2, 0, 0]], fsp_tol=args.fsp_tol,
        krylov_tol=1e-10, verbosity=1, device=args.device,
    )
    wall = time.perf_counter() - t0
    print(f"\nfinal FSP size {res.stats.final_fsp_size}, "
          f"wsum {res.wsum:.8f}, {res.stats.nstep} steps, {wall:.2f}s")
    return res


if __name__ == "__main__":
    main()
