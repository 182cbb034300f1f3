"""krylovfspssa_tpu_torch — the PyTorch/CUDA port of krylovfspssa_tpu.

Solves the Chemical Master Equation by the Krylov-FSP algorithm on one
device (``"cuda"`` by default; the CPU when asked for by name), on the
masked-box backend (``solve_cme_box``) or the table backend (``solve_cme``:
a sorted state table grown by SSA walks, the gather-ELL operator).  On an NVIDIA H100 the stencil SpMV is a hand-written
CUDA kernel body, ``csrc/sep_stencil.cuh`` (``ops/stencil_cuda.py``): its
separable mode for separable propensities, its direct mode for every
other model.  The JAX package ``krylovfspssa_tpu`` is the reference this port
is tested against; this package imports torch and numpy and never JAX.
"""

from .boxsolver import BoxCmeSolver, BoxSolveResult, solve_cme_box
from .config import SolverConfig
from .models.model import Model, load_model
from .solver import CmeSolver, SolveResult, solve_cme

__all__ = [
    "SolverConfig",
    "Model",
    "load_model",
    "BoxCmeSolver",
    "BoxSolveResult",
    "solve_cme_box",
    "CmeSolver",
    "SolveResult",
    "solve_cme",
]

__version__ = "0.1.0"
