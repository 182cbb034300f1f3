"""Built-in model constructors mirroring the reference examples.

Each function builds the same model as the corresponding reference driver
(``reference/examples/*.f90`` / ``test/TestSolverFromFile.f90``).
PyTorch port of ``krylovfspssa_tpu/models/library.py``: every
expression-defined model is here.  The two custom-propensity models
(``toggle_programmatic``, ``ge5d``) need the non-separable stencil kernel
(B5 in ROADMAP.md Queue B) on a GPU and are not ported yet; their factories
raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from .model import Model


def toggle_file_model() -> Model:
    """The 6-parameter basal toggle switch of ``models/toggle_model.input``
    (reference ``models/toggle_model.input:1-32``) with the parameter values
    used by ``TestSolverFromFile`` (test/TestSolverFromFile.f90:31:
    reset_parameters([1,100,1,1,100,1]))."""
    m = Model(
        n_species=2,
        n_reactions=4,
        n_parameters=6,
        stoichiometry=np.array([[1, 0], [-1, 0], [0, 1], [0, -1]]),
        species_names=["X", "Y"],
        parameter_names=["bx", "kx", "dx", "by", "ky", "dy"],
        propensity_expressions=[
            "bx + kx/(2.0 + 0.2*Y^2)",
            "dx*X",
            "by + ky/(1.0 + 0.5*X^1.5)",
            "dy*Y",
        ],
        name="toggle",
    )
    m.reset_parameters([1.0, 100.0, 1.0, 1.0, 100.0, 1.0])
    return m


def toggle_parser_model() -> Model:
    """The 4-parameter toggle variant of ``models/toggle_test_model.input``
    (reference ``models/toggle_test_model.input``) with the parameter values
    used by the parser test (test/TestModelParser.f90:15:
    reset_parameters([5000,1600,1,1]))."""
    m = Model(
        n_species=2,
        n_reactions=4,
        n_parameters=4,
        stoichiometry=np.array([[1, 0], [0, 1], [-1, 0], [0, -1]]),
        species_names=["X", "Y"],
        parameter_names=["kx", "ky", "dx", "dy"],
        propensity_expressions=[
            "kx/(1.0 + Y^2.5)",
            "ky/(1.0 + X^1.5)",
            "dx*X",
            "dy*Y",
        ],
        name="toggle_parser",
    )
    m.reset_parameters([5000.0, 1600.0, 1.0, 1.0])
    return m


def _needs_b5(name: str):
    raise NotImplementedError(
        f"model {name!r} has a custom propensity; the PyTorch port runs it "
        "only after the non-separable stencil kernel is ported (ROADMAP.md "
        "Queue B, kernel B5)"
    )


def toggle_programmatic_model() -> Model:
    """The programmatic toggle of ``examples/toggle.f90:23-48,55-69``
    (custom propensity; not ported yet, see :func:`_needs_b5`)."""
    _needs_b5("toggle_programmatic")


def repressilator_model() -> Model:
    """The 3-gene repressilator of ``examples/repressilator.f90:23-48,50-69``."""
    m = Model(
        n_species=3,
        n_reactions=6,
        n_parameters=3,
        stoichiometry=np.array(
            [
                [1, 0, 0],
                [-1, 0, 0],
                [0, 1, 0],
                [0, -1, 0],
                [0, 0, 1],
                [0, 0, -1],
            ]
        ),
        species_names=["S1", "S2", "S3"],
        parameter_names=["alpha", "kr", "d"],
        propensity_expressions=[
            "alpha/(1.0 + kr*S2^6.0)",
            "d*S1",
            "alpha/(1.0 + kr*S3^6.0)",
            "d*S2",
            "alpha/(1.0 + kr*S1^6.0)",
            "d*S3",
        ],
        name="repressilator",
    )
    m.reset_parameters([100.0, 25.0, 1.0])
    return m


GOUTSIAS_PARAMETERS = [
    0.043,
    0.0007,
    0.0715,
    0.0039,
    0.0199264663575241,
    0.4791,
    0.000199264663575241,
    0.8765e-11,
    0.0830269431563506104,
    0.5,
]


def goutsias_model() -> Model:
    """The 6-species, 10-reaction Goutsias transcription model of
    ``examples/transcr6d.f90`` (program solve_goutsias), with the stiff rate
    constants from transcr6d.f90:23-32."""
    # species: M D RNA DNA DNA.D DNA.2D  (transcr6d.f90:15)
    M, D, RNA, DNA, DNAD, DNA2D = range(6)
    stoich = np.zeros((10, 6), dtype=np.int64)
    stoich[0, M] = 1
    stoich[1, M] = -1
    stoich[2, RNA] = 1
    stoich[3, RNA] = -1
    stoich[4, DNA] = -1
    stoich[4, D] = -1
    stoich[4, DNAD] = 1
    stoich[5, DNA] = 1
    stoich[5, D] = 1
    stoich[5, DNAD] = -1
    stoich[6, DNAD] = -1
    stoich[6, D] = -1
    stoich[6, DNA2D] = 1
    stoich[7, DNAD] = 1
    stoich[7, D] = 1
    stoich[7, DNA2D] = -1
    stoich[8, M] = -2
    stoich[8, D] = 1
    stoich[9, M] = 2
    stoich[9, D] = -1
    m = Model(
        n_species=6,
        n_reactions=10,
        n_parameters=10,
        stoichiometry=stoich,
        species_names=["M", "D", "RNA", "DNA", "DNA.D", "DNA.2D"],
        parameter_names=[f"c{i}" for i in range(1, 11)],
        propensity_expressions=[
            "c1*RNA",
            "c2*M",
            "c3*DNA.D",
            "c4*RNA",
            "c5*DNA*D",
            "c6*DNA.D",
            "c7*DNA.D*D",
            "c8*DNA.2D",
            "c9*M*(M-1)/2.0d0",
            "c10*D",
        ],
        name="goutsias",
    )
    m.reset_parameters(GOUTSIAS_PARAMETERS)
    return m


def bursting_gene_model() -> Model:
    """Bursting gene expression.

    The shipped ``bursting_gene_model.input`` has no propensities section
    (``reference/models/bursting_gene_model.input``) and is unusable by
    the reference solver; this constructor supplies the standard telegraph /
    bursting-gene kinetics: gene toggles on/off, RNA is produced while on.
    """
    m = Model(
        n_species=2,
        n_reactions=4,
        n_parameters=4,
        stoichiometry=np.array([[1, 0], [-1, 0], [0, 1], [0, -1]]),
        species_names=["Gene_state", "RNA"],
        parameter_names=["k1", "k2", "k3", "k4"],
        propensity_expressions=[
            "k1*(1 - Gene_state)",
            "k2*Gene_state",
            "k3*Gene_state",
            "k4*RNA",
        ],
        name="bursting_gene",
    )
    m.reset_parameters([0.05, 0.05, 5.0, 1.0])
    return m


def ge5d_model() -> Model:
    """5-species gene expression with a 4-level gene state (custom
    propensity; not ported yet, see :func:`_needs_b5`)."""
    _needs_b5("ge5d")


LIBRARY = {
    "toggle": toggle_file_model,
    "toggle_parser": toggle_parser_model,
    "toggle_programmatic": toggle_programmatic_model,
    "repressilator": repressilator_model,
    "goutsias": goutsias_model,
    "bursting_gene": bursting_gene_model,
    "ge5d": ge5d_model,
}


#: parameter values the reference driver programs reset each bundled
#: ``models/*.input`` model to before solving (the .input format carries
#: parameter NAMES only; values come from RESET_PARAMETERS calls in the
#: drivers).  Keyed by input-file stem.
DRIVER_PARAMETERS = {
    # test/TestSolverFromFile.f90:31
    "toggle_model": [1.0, 100.0, 1.0, 1.0, 100.0, 1.0],
    # test/TestModelParser.f90:15
    "toggle_test_model": [5000.0, 1600.0, 1.0, 1.0],
    # examples/repressilator.f90:20-22
    "repressilator_model": [100.0, 25.0, 1.0],
    # examples/transcr6d.f90:23-32
    "goutsias_model": GOUTSIAS_PARAMETERS,
}


def get_model(name: str) -> Model:
    try:
        return LIBRARY[name]()
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(LIBRARY)}"
        ) from None
