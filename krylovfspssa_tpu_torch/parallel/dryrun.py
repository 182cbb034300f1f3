"""Multi-rank dry run (the JAX package's
``__graft_entry__.dryrun_multichip``): one row-sharded table step, then a
whole row-sharded box solve, as a check.

    python -m krylovfspssa_tpu_torch.parallel.dryrun 4              # 4 cards
    python -m krylovfspssa_tpu_torch.parallel.dryrun 4 --device cpu

It runs on the card, one per rank, unless the CPU is named: without CUDA
(or with fewer cards than ranks) it fails instead of moving to the CPU.
"""

from __future__ import annotations

import argparse
import sys

import torch


def _table_step(mesh):
    """The table half: one full adaptive step of the Goutsias operator on
    a reachable state set, its rows and the vector row-sharded over the
    mesh at a capacity that divides by any rank count up to 64.  Returns
    (capacity, n, t_now, iexpand, wsum of the returned vector)."""
    import numpy as np
    import torch

    from ..config import SolverConfig
    from ..krylov.stepper import initial_carry
    from ..models.library import goutsias_model
    from ..ops.operator import build_operator
    from ..statespace.encoding import StateEncoder
    from ..statespace.expand import onestep_extend
    from ..statespace.table import StateTable
    from .sharded import sharded_step_fn, table_rows

    model = goutsias_model()
    cap = max(256, mesh.size * 64)
    enc = StateEncoder.for_model(model.n_species, 10_000)
    table = StateTable.from_states(
        np.array([[2, 6, 0, 2, 0, 0]], dtype=np.int32), enc, capacity=cap,
        device=mesh.device)
    while table.n < cap // 2:
        table, added = onestep_extend(table, model.stoichiometry, cap)
        if added == 0:
            break
    dev = mesh.device
    rows = table_rows(mesh, table.capacity)
    op = build_operator(
        torch.as_tensor(table.states, device=dev),
        torch.as_tensor(table.sorted_keys, device=dev),
        torch.as_tensor(table.sorted_to_row, device=dev), table.n,
        model.propensities, model.stoichiometry, enc, rows=rows)
    config = SolverConfig()
    w = torch.zeros(rows[1], dtype=torch.float64, device=dev)
    if rows[0] == 0:
        w[0] = 1.0
    step = sharded_step_fn(mesh, config)
    res = step(op, w, initial_carry(1.0, 300.0, 1e-8, config.anorm,
                                    config.m_min), 300.0, 1e-6, 1e-8)
    mass = float(mesh.sum(torch.sum(res.w.to(torch.float64))))
    return (table.capacity, table.n, float(res.carry.t_now),
            bool(res.iexpand), int(res.carry.iflag), mass)


def _dryrun_rank(mesh):
    from ..boxsolver import BoxCmeSolver
    from ..config import SolverConfig
    from ..models.library import bursting_gene_model

    table = _table_step(mesh)
    solver = BoxCmeSolver(bursting_gene_model(), SolverConfig(), mesh=mesh)
    res = solver.solve(5.0, [[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8)
    return (table, res) if mesh.rank == 0 else None


def dryrun_multichip(n_devices: int, device: str = "cuda"):
    """On ``n_devices`` ranks of this host (one card each with NCCL, or
    gloo ranks for ``device="cpu"``): one sharded table step (Goutsias,
    the table backend's flagship operator), which must advance time or
    ask for an expansion without losing its mass, then the full sharded
    box solve (bursting gene, t=5, fsp_tol 1e-4, krylov_tol 1e-8: box
    growth, drops and dilation rounds), which must reach t_out with its
    mass.  Returns rank 0's box result; raises on a failed check, and
    where ``device="cuda"`` finds fewer than ``n_devices`` cards."""
    from .multihost import spawn

    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_devices:
            raise RuntimeError(f"dryrun_multichip on cuda needs {n_devices} "
                               f"cards, {cards} visible")
        devices, backend = [f"cuda:{r}" for r in range(n_devices)], "nccl"
    else:
        devices, backend = [device] * n_devices, "gloo"
    (cap, n, t_now, expanding, iflag, mass), res = spawn(
        _dryrun_rank, devices, backend=backend)[0]
    # one attempted step either advances time or abandons into an SSA
    # expansion; both prove that the sharded step ran
    if not (t_now > 0.0 or expanding) or iflag != 0:
        raise RuntimeError(f"sharded table step neither advanced nor "
                           f"expanded (t_now={t_now}, iflag={iflag})")
    if not mass > 0.99:
        raise RuntimeError(f"sharded table step lost its mass: {mass}")
    print(f"dryrun_multichip ok (table backend): {n_devices} ranks on "
          f"{device}, cap={cap}, n={n}, t_now={t_now:.3g}, "
          f"wsum={mass:.6f}")
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
