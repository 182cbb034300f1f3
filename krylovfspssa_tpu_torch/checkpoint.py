"""Checkpoint / resume for in-progress box solves (PyTorch port of the box
half of ``krylovfspssa_tpu/checkpoint.py``).

A solve's entire state is a handful of arrays — box geometry, mask,
probability vector, and the scalar ``StepCarry`` — written as ``.npz`` in
the JAX package's format (``FORMAT_VERSION = 1``, same keys and dtypes).
A snapshot written by either package's ``BoxCmeSolver`` resumes in the
other: this system has no weights, so this is how state crosses between
the two.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .boxspace.box import BoxSpace
from .krylov.stepper import StepCarry, carry_from_numpy

FORMAT_VERSION = 1

__all__ = ["FORMAT_VERSION", "carry_from_numpy", "load_checkpoint",
           "save_checkpoint"]


def save_checkpoint(
    path: str | Path,
    box: BoxSpace,
    mask: np.ndarray,
    w: np.ndarray,
    carry: StepCarry,
    t_out: float,
    fsp_tol: float,
    krylov_tol: float,
) -> None:
    """Atomically write a solve snapshot (write temp + rename)."""
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


def load_checkpoint(path: str | Path):
    """Returns (box, mask, w, carry, t_out, fsp_tol, krylov_tol) with
    numpy mask/w and a host StepCarry."""
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
        return (
            box,
            z["mask"],
            z["w"],
            carry,
            float(z["t_out"]),
            float(z["fsp_tol"]),
            float(z["krylov_tol"]),
        )
