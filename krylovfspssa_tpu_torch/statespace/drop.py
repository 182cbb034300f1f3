"""Probability-mass-based state dropping on the masked box (PyTorch port
of ``krylovfspssa_tpu/statespace/drop.py``).

Reference: ``FIND_DROPTOL`` + ``DROP_STATES``
(``reference/src/state_space/StateSpace.f90:398-548``): find the
largest threshold in {1e-8, 1e-9, ...} whose below-threshold probability
mass stays under the droppable surplus ``dsum``; mark states below it,
un-mark states with large probability inflow (A w)_i.  On the box, a drop
clears mask bits.  The reference's double-decrement defect in the drop
counter (StateSpace.f90:490-495) is not replicated; the count here is the
true size of the drop set.
"""

from __future__ import annotations

import torch

#: threshold ladder 1e-8, 1e-9, ... (StateSpace.f90:416-426)
_N_LEVELS = 24


def drop_mask_device(
    w: torch.Tensor,
    inflow: torch.Tensor,
    active: torch.Tensor,
    dsum: float,
    droptol_start: float = 1.0e-8,
    inflow_guard: float = 1.0e-8,
    reduce=None,
):
    """Compute the drop mask on the vectors' device.

    Args:
      w: (vol,) float64 probability vector.
      inflow: (vol,) float64 A @ w (the inflow guard vector,
        StateSpace.f90:486).
      active: (vol,) bool membership mask.
      dsum: droppable surplus mass.
      reduce: a mesh's ``sum`` when the vectors are this rank's rows of a
        row-sharded box (the ladder and the count are then over all ranks:
        one all_reduce each).

    Returns:
      (mask (vol,) bool — True = drop, count int, droptol float).
    """
    total = (lambda t: t) if reduce is None else reduce
    levels = [droptol_start / 10.0 ** i for i in range(_N_LEVELS)]
    # mass below each level, counting only 0 < w < level (FIND_DROPTOL);
    # one masked sum per level keeps the temporaries at O(vol)
    live = torch.where(active & (w > 0), w, 0.0)
    sums = total(torch.stack(
        [torch.sum(torch.where(w < lev, live, 0.0)) for lev in levels]
    )).tolist()
    # first level whose mass fits; fall back to the smallest
    droptol = next((lev for lev, s in zip(levels, sums) if s < dsum),
                   levels[-1])
    mask = (w < droptol) & active & ~(inflow > inflow_guard)
    return mask, int(total(mask.sum())), droptol


def drop_loss_rate(w, inflow, diag, dmask, reduce=None) -> float:
    """Gross inflow rate into the drop set (the anti-thrash gate input).

    The reference's per-state inflow guard (StateSpace.f90:486-495) tests
    the NET derivative (A w)_i, which is ~0 for a quasi-equilibrated
    boundary state that still carries real throughput.  Dropping such a
    state truncates the GROSS flux (A w)_i + D_i w_i — the rate the FSP
    criterion will charge on the next step.  ``config.drop_rate_frac``
    gates drop commits on this sum staying under a fraction of the FSP
    budget rate fsp_tol/t_out (a fix for the drop/expand limit cycle; no
    reference counterpart).

    Args:
      w: (vol,) f64 probability vector.
      inflow: (vol,) f64 A @ w.
      diag: (vol,) f64 positive total-outflow diagonal D.
      dmask: (vol,) bool drop set.
      reduce: a mesh's ``sum`` under a row-sharded box.
    """
    gross = inflow + diag * w
    loss = torch.sum(torch.where(dmask, torch.clamp_min(gross, 0.0), 0.0))
    return float(loss if reduce is None else reduce(loss))
