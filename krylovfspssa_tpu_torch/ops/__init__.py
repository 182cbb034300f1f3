from .expm import expm_pade
from .stencil import make_stencil_matvec, select_stencil_matvec

__all__ = ["expm_pade", "make_stencil_matvec", "select_stencil_matvec"]
