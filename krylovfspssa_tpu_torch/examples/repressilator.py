"""Repressilator oscillator.

Mirrors the reference ``examples/repressilator.f90``: 3 species,
6 reactions, x0 = (22, 0, 0), t = 10, krylov_tol = 1e-14.

Run:  python -m krylovfspssa_tpu_torch.examples.repressilator [--device cuda]
"""

import argparse
import time

from krylovfspssa_tpu_torch.boxsolver import solve_cme_box
from krylovfspssa_tpu_torch.models.library import repressilator_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = repressilator_model()
    t0 = time.perf_counter()
    res = solve_cme_box(
        model, args.t, [[22, 0, 0]], fsp_tol=1e-4, krylov_tol=1e-14,
        verbosity=1, device=args.device,
    )
    wall = time.perf_counter() - t0
    print(f"\nfinal FSP size {res.stats.final_fsp_size}, "
          f"wsum {res.wsum:.8f}, {res.stats.nstep} steps, {wall:.2f}s")
    return res


if __name__ == "__main__":
    main()
