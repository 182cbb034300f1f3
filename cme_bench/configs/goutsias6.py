"""The Goutsias 6-species transcription-regulation network.

Reference ``examples/transcr6d.f90`` (program solve_goutsias) of
github.com/voduchuy/KrylovFspSsa, whose network is the repository's
``models/goutsias_model.input``, copied in below: 6 species, 10
reactions, rate constants over ten orders of magnitude.  Its matvecs run
the port's ``box_stencil`` on the box and the ELL SpMV on the table.  The
published horizon is t=300; the cells cut it in their traffic (at t=30
the box needs 2^24 cells, over the default ``max_box_volume``; one t=300
table solve takes minutes).
"""

import numpy as np

NAME = "goutsias6"
SOURCE = ("https://github.com/voduchuy/KrylovFspSsa examples/transcr6d.f90; "
          "Sidje & Vo, Math. Biosci. 269 (2015)")
REDUCED = ["t_out"]
ASSUMED = {"dtype": "float64: the reference example's REAL(8) throughout"}

#: models/goutsias_model.input
MODEL_INPUT = """\
nspecies
6

nreactions
10

nparameters
10

species
M
D
RNA
DNA
DNA.D
DNA.2D

parameters
c1
c2
c3
c4
c5
c6
c7
c8
c9
c10

reactions
RNA -> RNA + M
M -> 0
DNA.D -> RNA + DNA.D
RNA -> 0
DNA + D -> DNA.D
DNA.D -> DNA + D
DNA.D + D -> DNA.2D
DNA.2D -> DNA.D + D
2M -> D
D -> 2M

propensities
c1*RNA
c2*M
c3*DNA.D
c4*RNA
c5*DNA*D
c6*DNA.D
c7*DNA.D*D
c8*DNA.2D
c9*M*(M-1)/2.0d0
c10*D
"""

SPECIES = ["M", "D", "RNA", "DNA", "DNA.D", "DNA.2D"]
#: transcr6d.f90's rate constants
PARAMETERS = [0.043, 0.0007, 0.0715, 0.0039, 0.0199264663575241, 0.4791,
              0.000199264663575241, 0.8765e-11, 0.0830269431563506104, 0.5]
STOICHIOMETRY = np.array([
    [1, 0, 0, 0, 0, 0],
    [-1, 0, 0, 0, 0, 0],
    [0, 0, 1, 0, 0, 0],
    [0, 0, -1, 0, 0, 0],
    [0, -1, 0, -1, 1, 0],
    [0, 1, 0, 1, -1, 0],
    [0, -1, 0, 0, -1, 1],
    [0, 1, 0, 0, 1, -1],
    [-2, 1, 0, 0, 0, 0],
    [2, -1, 0, 0, 0, 0],
])
X0 = [2, 6, 0, 2, 0, 0]
#: the published horizon (cut in the cells' traffic: REDUCED)
T_OUT = 300.0
FSP_TOL = 1e-6
KRYLOV_TOL = 1e-8
DTYPE = "float64"


def model():
    """The network as a model of the program under test, parsed from the
    ``.input`` text, at the published parameters."""
    import os
    import tempfile

    from krylovfspssa_tpu_torch import load_model

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "goutsias_model.input")
        with open(path, "w") as f:
            f.write(MODEL_INPUT)
        m = load_model(path, name=NAME)
    m.reset_parameters(PARAMETERS)
    return m
