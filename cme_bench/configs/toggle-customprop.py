"""The genetic toggle switch as the reference's CUSTOMPROP example builds it.

Reference ``examples/toggle.f90`` of github.com/voduchuy/KrylovFspSsa
(Sidje & Vo, Math. Biosci. 269, 2015): two mutually repressing genes, 2
species, 4 reactions, the propensities given as a function rather than as
expressions.  On the card its matvecs run the port's ``direct_stencil``.
Nothing is cut: the published parameters, x0, horizon and tolerances.
"""

import numpy as np
import torch

NAME = "toggle-customprop"
SOURCE = ("https://github.com/voduchuy/KrylovFspSsa examples/toggle.f90; "
          "Sidje & Vo, Math. Biosci. 269 (2015)")
#: keys changed from the source
REDUCED: list[str] = []
#: sizes the source does not give, set here
ASSUMED = {"dtype": "float64: the reference example's REAL(8) throughout"}

SPECIES = ["X", "Y"]
PARAMETER_NAMES = ["b1", "k1", "d1", "b2", "k2", "d2"]
#: examples/toggle.f90's rate constants
PARAMETERS = [1.0, 100.0, 1.0, 1.0, 100.0, 1.0]
STOICHIOMETRY = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]])
X0 = [0, 0]
T_OUT = 100.0
FSP_TOL = 1e-4
KRYLOV_TOL = 1e-10
DTYPE = "float64"


def propensity(states, r, p):
    """The example's CUSTOMPROP function, batched over ``states``."""
    x, y = states[..., 0], states[..., 1]
    if r == 0:
        return p[0] + p[1] / (1.0 + y * torch.sqrt(y))
    if r == 1:
        return p[2] * x
    if r == 2:
        return p[3] + p[4] / (1.0 + x ** 3.5)
    return p[5] * y


def model():
    """The network as a model of the program under test, at the published
    parameters."""
    from krylovfspssa_tpu_torch import Model

    m = Model(n_species=2, n_reactions=4, n_parameters=6,
              stoichiometry=STOICHIOMETRY, species_names=SPECIES,
              parameter_names=PARAMETER_NAMES, custom_propensity=propensity,
              name=NAME)
    m.reset_parameters(PARAMETERS)
    return m
