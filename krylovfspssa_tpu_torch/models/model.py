"""CME model definition and ``.input`` file loader.

Parity with the reference model layer (``reference/src/model/
ModelModule.f90``):

* ``Model`` holds species/reaction/parameter counts, a dense stoichiometry
  matrix, parameter values, and per-reaction propensities that are either
  compiled expression strings (ModelModule.f90:163-199) or a user-supplied
  callable (parity with the ``CUSTOMPROP`` pointer, ModelModule.f90:31).
* ``load_model`` reads the keyword-sectioned text format
  (ModelModule.f90:91-158).  Keyword matching is case-insensitive: the
  reference compares uppercased keywords while all bundled ``models/*.input``
  files are lowercase — a defect this loader fixes.
* The reaction-equation parser handles ``->`` / ``<-``, integer
  coefficients, and the ``0`` void term (ModelModule.f90:219-297).  The
  reference's stale-coefficient defect (COEFF not reset when a species name
  occurs mid-term, ModelModule.f90:276-284) is fixed: a term matches a
  species only when an optional integer prefix is followed by the full
  species name.

Propensities are evaluated *batched* on torch tensors — one call produces
the (n_states, n_reactions) float64 propensity matrix for the whole state
set on the states' device, instead of the reference's scalar bytecode
interpreter call per (state, reaction) pair (ModelModule.f90:191-196).
This module is the PyTorch port of ``krylovfspssa_tpu/models/model.py``;
the loader and reaction parser are unchanged.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from .expressions import compile_expression

#: signature: (states (n, d) float tensor, reaction index, params (p,)) -> (n,)
CustomPropensity = Callable[[torch.Tensor, int, torch.Tensor], torch.Tensor]


class ModelError(ValueError):
    """Raised on an invalid model definition or input file."""


@dataclasses.dataclass
class Model:
    """A stochastic chemical kinetics model defining a CME."""

    n_species: int
    n_reactions: int
    n_parameters: int
    #: (n_reactions, n_species) int — row r is the state change of reaction r.
    #: (The reference stores the transpose, species x reactions,
    #: ModelModule.f90:25.)
    stoichiometry: np.ndarray
    species_names: list[str] = dataclasses.field(default_factory=list)
    parameter_names: list[str] = dataclasses.field(default_factory=list)
    parameters: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.float64)
    )
    #: propensity expression strings, one per reaction (may be empty if a
    #: custom propensity is attached)
    propensity_expressions: list[str] = dataclasses.field(default_factory=list)
    #: parity with the reference CUSTOMPROP pointer: when set, overrides the
    #: parsed expressions (ModelModule.f90:188-189)
    custom_propensity: CustomPropensity | None = None
    name: str = "model"

    _compiled: list | None = dataclasses.field(default=None, repr=False)

    # ------------------------------------------------------------------ #

    def __post_init__(self):
        self.stoichiometry = np.asarray(self.stoichiometry, dtype=np.int64)
        if self.stoichiometry.shape != (self.n_reactions, self.n_species):
            raise ModelError(
                f"stoichiometry shape {self.stoichiometry.shape} != "
                f"({self.n_reactions}, {self.n_species})"
            )
        self.parameters = np.asarray(self.parameters, dtype=np.float64)
        if self.parameters.size == 0:
            self.parameters = np.zeros(self.n_parameters, dtype=np.float64)

    def reset_parameters(self, values: Sequence[float]) -> None:
        """Set parameter values; extra trailing values are ignored, matching
        the reference (ModelModule.f90:215 copies only the first
        ``n_parameters`` entries — ``TestSolverFromFile`` passes 6 values to
        a 4-parameter model)."""
        values = np.asarray(values, dtype=np.float64)
        if values.size < self.n_parameters:
            raise ModelError(
                f"need {self.n_parameters} parameter values, got {values.size}"
            )
        self.parameters = values[: self.n_parameters].copy()

    # ------------------------------------------------------------------ #

    def _ensure_compiled(self):
        if self._compiled is None:
            if len(self.propensity_expressions) != self.n_reactions:
                raise ModelError(
                    f"model {self.name!r} has "
                    f"{len(self.propensity_expressions)} propensity "
                    f"expressions for {self.n_reactions} reactions and no "
                    "custom propensity"
                )
            variables = list(self.species_names) + list(self.parameter_names)
            self._compiled = [
                compile_expression(e, variables)
                for e in self.propensity_expressions
            ]
        return self._compiled

    def propensities(self, states, params=None) -> torch.Tensor:
        """Batched propensity evaluation.

        Args:
          states: (n, n_species) integer or float array or tensor; a
            tensor keeps its device.
          params: optional (n_parameters,) overriding ``self.parameters``.

        Returns:
          (n, n_reactions) float64 propensity tensor on the states' device.
        """
        device = states.device if isinstance(states, torch.Tensor) else "cpu"
        x = torch.as_tensor(states, device=device).to(torch.float64)
        if params is None:
            params = self.parameters
        params = torch.as_tensor(params, dtype=torch.float64, device=device)
        n = x.shape[0]
        if self.custom_propensity is not None:
            cols = [
                torch.as_tensor(
                    self.custom_propensity(x, r, params),
                    dtype=torch.float64, device=device,
                ).broadcast_to((n,))
                for r in range(self.n_reactions)
            ]
            return torch.stack(cols, dim=1)
        fns = self._ensure_compiled()
        env = {name: x[:, j] for j, name in enumerate(self.species_names)}
        env.update(
            {name: params[j] for j, name in enumerate(self.parameter_names)}
        )
        cols = [
            torch.as_tensor(
                fn(env), dtype=torch.float64, device=device
            ).broadcast_to((n,))
            for fn in fns
        ]
        return torch.stack(cols, dim=1)

    def propensity(self, state, reaction: int, params=None) -> float:
        """Scalar convenience wrapper (parity with MODEL%PROPENSITY,
        ModelModule.f90:163): 0-based reaction index."""
        out = self.propensities(np.asarray(state)[None, :], params)
        return float(out[0, reaction])


# ===================================================================== #
#                             input loader                              #
# ===================================================================== #

_KEYWORDS = {
    "nspecies",
    "nreactions",
    "nparameters",
    "species",
    "parameters",
    "reactions",
    "propensities",
}


def _significant_lines(text: str) -> list[str]:
    out = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if line.strip():
            out.append(line.strip())
    return out


def load_model(path: str | Path, name: str | None = None) -> Model:
    """Load a model from the keyword-sectioned ``.input`` text format.

    Sections (any order honoring the reference's dependency rules):
    ``nspecies``, ``nreactions``, ``nparameters`` followed by an integer
    line; ``species`` / ``parameters`` followed by one name per line;
    ``reactions`` followed by one reaction equation per line;
    ``propensities`` followed by one expression per line
    (ModelModule.f90:91-158).  Lines after ``#`` are comments.
    """
    path = Path(path)
    lines = _significant_lines(path.read_text())
    model_name = name or path.stem

    n_species = n_reactions = n_parameters = None
    species: list[str] = []
    parameters: list[str] = []
    reaction_lines: list[str] = []
    prop_lines: list[str] = []

    i = 0

    def need_int(what: str) -> int:
        nonlocal i
        if i >= len(lines):
            raise ModelError(f"{path}: missing value after '{what}'")
        try:
            v = int(lines[i].split()[0])
        except ValueError as e:
            raise ModelError(f"{path}: bad integer for '{what}': {lines[i]!r}") from e
        i += 1
        return v

    def take_names(count: int, what: str) -> list[str]:
        nonlocal i
        out = []
        for _ in range(count):
            if i >= len(lines) or lines[i].lower() in _KEYWORDS:
                raise ModelError(f"{path}: expected {count} {what} names")
            out.append(lines[i].split()[0])
            i += 1
        return out

    def take_lines(count: int, what: str) -> list[str]:
        nonlocal i
        out = []
        for _ in range(count):
            if i >= len(lines) or lines[i].lower() in _KEYWORDS:
                raise ModelError(f"{path}: expected {count} {what} lines")
            out.append(lines[i])
            i += 1
        return out

    while i < len(lines):
        key = lines[i].lower()
        i += 1
        if key == "nspecies":
            n_species = need_int(key)
        elif key == "nreactions":
            n_reactions = need_int(key)
        elif key == "nparameters":
            n_parameters = need_int(key)
        elif key == "species":
            if n_species is None:
                raise ModelError(f"{path}: 'species' before 'nspecies'")
            species = take_names(n_species, "species")
        elif key == "parameters":
            if n_parameters is None:
                # reference: hard STOP (ModelModule.f90:131)
                raise ModelError(f"{path}: 'parameters' before 'nparameters'")
            parameters = take_names(n_parameters, "parameter")
        elif key == "reactions":
            if not species or n_reactions is None:
                # reference: hard STOP (ModelModule.f90:120-122)
                raise ModelError(
                    f"{path}: 'reactions' requires species and nreactions first"
                )
            reaction_lines = take_lines(n_reactions, "reaction")
        elif key == "propensities":
            if not species or (n_parameters and not parameters):
                raise ModelError(
                    f"{path}: 'propensities' requires species and parameter "
                    "names first"
                )
            prop_lines = take_lines(n_reactions or 0, "propensity")
        else:
            # unknown lines are skipped, as in the reference keyword scanner
            continue

    if n_species is None or n_reactions is None:
        raise ModelError(f"{path}: nspecies/nreactions not declared")
    if n_parameters is None:
        n_parameters = 0
    if len(reaction_lines) != n_reactions:
        raise ModelError(
            f"{path}: declared {n_reactions} reactions but found "
            f"{len(reaction_lines)}"
        )

    stoich = np.zeros((n_reactions, n_species), dtype=np.int64)
    for r, line in enumerate(reaction_lines):
        stoich[r] = parse_reaction(line, species)

    if prop_lines and len(prop_lines) != n_reactions:
        raise ModelError(
            f"{path}: declared {n_reactions} reactions but found "
            f"{len(prop_lines)} propensities"
        )

    return Model(
        n_species=n_species,
        n_reactions=n_reactions,
        n_parameters=n_parameters,
        stoichiometry=stoich,
        species_names=species,
        parameter_names=parameters,
        propensity_expressions=prop_lines,
        name=model_name,
    )


def parse_reaction(line: str, species: Sequence[str]) -> np.ndarray:
    """Parse one reaction equation line into a stoichiometry row.

    Grammar (ModelModule.f90:219-297): whitespace-separated terms, a single
    ``->`` or ``<-`` arrow, terms joined by ``+``; each term is an optional
    integer coefficient immediately followed by a species name, or ``0`` for
    the void.  ``<-`` swaps reactant/product roles.
    """
    tokens = line.split()
    direction = 0
    n_left = None
    terms: list[str] = []
    for tok in tokens:
        if tok == "->":
            direction = 1
            n_left = len(terms)
        elif tok == "<-":
            direction = 2
            n_left = len(terms)
        elif tok == "+":
            continue
        else:
            terms.append(tok)
    if direction == 0:
        raise ModelError(f"reaction {line!r}: no '->' or '<-' arrow")

    vec = np.zeros(len(species), dtype=np.int64)
    for t, term in enumerate(terms):
        if term == "0":
            continue
        coeff, idx = _match_term(term, species)
        if idx is None:
            warnings.warn(
                f"species {term!r} not defined in the model", stacklevel=2
            )
            continue
        if t < (n_left or 0):
            vec[idx] -= coeff
        else:
            vec[idx] += coeff
    if direction == 2:
        vec = -vec
    return vec


def _match_term(term: str, species: Sequence[str]) -> tuple[int, int | None]:
    """Match ``term`` = [integer coefficient] + full species name."""
    for idx, name in enumerate(species):
        if term == name:
            return 1, idx
        if term.endswith(name):
            prefix = term[: len(term) - len(name)]
            if prefix.isdigit():
                return int(prefix), idx
    return 0, None
