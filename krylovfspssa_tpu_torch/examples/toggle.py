"""Toggle switch built programmatically with a custom propensity callable.

Mirrors the reference ``examples/toggle.f90``: 2 species, 4 reactions,
x0 = (0, 0), t = 100, fsp_tol 1e-4, krylov_tol 1e-10, with the propensities
supplied as a Python function (the CUSTOMPROP parity path) instead of
expressions.  On a GPU its matvecs run the ``direct_stencil`` kernel.

Run:  python -m krylovfspssa_tpu_torch.examples.toggle [--t 100] [--device cuda]
"""

import argparse
import time

import numpy as np

from krylovfspssa_tpu_torch.boxsolver import solve_cme_box
from krylovfspssa_tpu_torch.models.library import toggle_programmatic_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=float, default=100.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = toggle_programmatic_model()
    t0 = time.perf_counter()
    res = solve_cme_box(
        model, args.t, [[0, 0]], fsp_tol=1e-4, krylov_tol=1e-10,
        verbosity=1, device=args.device,
    )
    wall = time.perf_counter() - t0
    print(f"\nfinal FSP size {res.stats.final_fsp_size}, "
          f"wsum {res.wsum:.8f}, {res.stats.nstep} steps, {wall:.2f}s")
    for s, name in enumerate(model.species_names):
        mean = float(np.sum(res.states[:, s] * res.probabilities))
        print(f"E[{name}] = {mean:.4f}")
    return res


if __name__ == "__main__":
    main()
