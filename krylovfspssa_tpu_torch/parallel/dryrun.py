"""Multi-rank dry run: a whole row-sharded box solve as a check (the box
half of the JAX package's ``__graft_entry__.dryrun_multichip``; its table
half waits for the row-sharded table backend, ROADMAP.md Queue A item 22).

    python -m krylovfspssa_tpu_torch.parallel.dryrun 4              # 4 cards
    python -m krylovfspssa_tpu_torch.parallel.dryrun 4 --device cpu

It runs on the card, one per rank, unless the CPU is named: without CUDA
(or with fewer cards than ranks) it fails instead of moving to the CPU.
"""

from __future__ import annotations

import argparse
import sys

import torch


def _dryrun_rank(mesh):
    from ..boxsolver import BoxCmeSolver
    from ..config import SolverConfig
    from ..models.library import bursting_gene_model

    solver = BoxCmeSolver(bursting_gene_model(), SolverConfig(), mesh=mesh)
    res = solver.solve(5.0, [[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8)
    return res if mesh.rank == 0 else None


def dryrun_multichip(n_devices: int, device: str = "cuda"):
    """Run the full sharded box solve (bursting gene, t=5, fsp_tol 1e-4,
    krylov_tol 1e-8: box growth, drops and dilation rounds) on
    ``n_devices`` ranks of this host — one card each with NCCL, or gloo
    ranks for ``device="cpu"`` — and check that it reached t_out with its
    mass.  Returns rank 0's result; raises on a failed check, and where
    ``device="cuda"`` finds fewer than ``n_devices`` cards."""
    from .multihost import spawn

    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_devices:
            raise RuntimeError(f"dryrun_multichip on cuda needs {n_devices} "
                               f"cards, {cards} visible")
        devices, backend = [f"cuda:{r}" for r in range(n_devices)], "nccl"
    else:
        devices, backend = [device] * n_devices, "gloo"
    res = spawn(_dryrun_rank, devices, backend=backend)[0]
    if res.stats.t_final < 5.0 or res.stats.nstep < 1:
        raise RuntimeError(f"sharded solve did not reach t_out: "
                           f"t_final={res.stats.t_final}")
    if not res.wsum >= 1.0 - 1e-4:
        raise RuntimeError(f"mass lost: wsum={res.wsum}")
    print(
        f"dryrun_multichip ok (box backend, full sharded solve): "
        f"{n_devices} ranks on {device}, vol={res.box.volume}, "
        f"steps={res.stats.nstep}, fsp={res.stats.final_fsp_size}, "
        f"wsum={res.wsum:.8f}"
    )
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ranks", type=int)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = p.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
