"""Checkpoint / resume for in-progress solves (PyTorch port of
``krylovfspssa_tpu/checkpoint.py``).

A solve's entire state is a handful of arrays — box geometry, mask,
probability vector, and the scalar ``StepCarry`` — written as ``.npz`` in
the JAX package's format (``FORMAT_VERSION = 1``, same keys and dtypes).
A snapshot written by either package's ``BoxCmeSolver`` resumes in the
other: this system has no weights, so this is how state crosses between
the two.

Under a mesh of ranks (parallel/sharded.py) the file is the same: rank 0
writes the gathered mask and vector, and every rank reads the whole file
and keeps its own rows.  A snapshot therefore resumes on any number of
ranks, and in either package, whatever wrote it.

A table-backend snapshot (``save_table_checkpoint``) holds the active
states, the probability vector over them, the carry, the tolerances and
``rng_state``, the SSA key (solver.py): the JAX package's fields, so it
too crosses between the packages both ways.  The two packages draw
different SSA streams from one key, so a resume in the other package
agrees with the original solve up to the SSA stream (the FSP tolerance).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .boxspace.box import BoxSpace
from .krylov.stepper import StepCarry, carry_from_numpy

FORMAT_VERSION = 1

__all__ = ["FORMAT_VERSION", "carry_from_numpy", "load_checkpoint",
           "load_table_checkpoint", "save_checkpoint",
           "save_table_checkpoint"]


def save_checkpoint(
    path: str | Path,
    box: BoxSpace,
    mask: np.ndarray,
    w: np.ndarray,
    carry: StepCarry,
    t_out: float,
    fsp_tol: float,
    krylov_tol: float,
    mesh=None,
) -> None:
    """Atomically write a solve snapshot (write temp + rename).

    With ``mesh``, ``mask`` and ``w`` are this rank's rows (tensors): every
    rank calls this, rank 0 writes the gathered arrays, and each rank
    returns once the file is in place."""
    if mesh is not None:
        from .parallel.multihost import host_gather

        mask = host_gather(mask, mesh)
        w = host_gather(w.to(torch.float64), mesh)
        if mesh.rank == 0:
            save_checkpoint(path, box, mask, w, carry, t_out, fsp_tol,
                            krylov_tol)
        mesh.barrier()
        return
    path = Path(path)
    fields = {f"carry_{k}": np.asarray(v) for k, v in carry._asdict().items()}
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            version=FORMAT_VERSION,
            n_species=box.n_species,
            axis_of_species=np.asarray(box.axis_of_species, np.int64),
            log2=np.asarray(box.log2, np.int64),
            stoichiometry=np.asarray(box.stoichiometry, np.int64),
            mask=np.asarray(mask),
            w=np.asarray(w, np.float64),
            t_out=float(t_out),
            fsp_tol=float(fsp_tol),
            krylov_tol=float(krylov_tol),
            **fields,
        )
    tmp.replace(path)


def load_checkpoint(path: str | Path, mesh=None):
    """Returns (box, mask, w, carry, t_out, fsp_tol, krylov_tol) with
    numpy mask/w and a host StepCarry; with ``mesh``, mask and w are this
    rank's rows."""
    with np.load(Path(path)) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {version} != expected {FORMAT_VERSION}"
            )
        box = BoxSpace(
            n_species=int(z["n_species"]),
            axis_of_species=tuple(int(a) for a in z["axis_of_species"]),
            log2=tuple(int(b) for b in z["log2"]),
            stoichiometry=z["stoichiometry"],
        )
        carry = carry_from_numpy(
            {k: z[f"carry_{k}"] for k in StepCarry._fields}
        )
        mask, w = z["mask"], z["w"]
        if mesh is not None:
            z0, n = mesh.rows(box.volume)
            mask, w = mask[z0:z0 + n], w[z0:z0 + n]
        return (
            box,
            mask,
            w,
            carry,
            float(z["t_out"]),
            float(z["fsp_tol"]),
            float(z["krylov_tol"]),
        )


# ------------------------------------------------------- table backend ----


def save_table_checkpoint(
    path: str | Path,
    states: np.ndarray,
    w: np.ndarray,
    carry: StepCarry,
    t_out: float,
    fsp_tol: float,
    krylov_tol: float,
    rng_state: np.ndarray,
) -> None:
    """Atomically write a table-backend snapshot: the active state list,
    the probability vector over it, the adaptive carry, the tolerances
    and the SSA key (so resumed expansion walks continue the key chain)."""
    path = Path(path)
    fields = {f"carry_{k}": np.asarray(v) for k, v in carry._asdict().items()}
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            version=FORMAT_VERSION,
            backend="table",
            states=np.asarray(states, np.int32),
            w=np.asarray(w, np.float64),
            t_out=float(t_out),
            fsp_tol=float(fsp_tol),
            krylov_tol=float(krylov_tol),
            rng_state=np.asarray(rng_state),
            **fields,
        )
    tmp.replace(path)


def load_table_checkpoint(path: str | Path):
    """Returns (states, w, carry, t_out, fsp_tol, krylov_tol, rng_state)
    with numpy arrays and a host StepCarry."""
    with np.load(Path(path)) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {version} != expected {FORMAT_VERSION}"
            )
        if "backend" not in z.files or str(z["backend"]) != "table":
            raise ValueError("not a table-backend checkpoint")
        carry = carry_from_numpy(
            {k: z[f"carry_{k}"] for k in StepCarry._fields}
        )
        return (
            z["states"],
            z["w"],
            carry,
            float(z["t_out"]),
            float(z["fsp_tol"]),
            float(z["krylov_tol"]),
            z["rng_state"],
        )
