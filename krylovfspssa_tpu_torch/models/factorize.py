"""Per-species factorization of propensity expressions.

CME propensities are almost universally *separable*: a product of
single-species factors times a rate constant,

    a_k(x) = C_k * prod_s f_{k,s}(x_s)

(mass action ``c*x1*x2``, ``c*x*(x-1)/2``, Hill terms ``b/(1+a*x^n)`` —
every bundled reference model has this form, e.g.
``reference/examples/transcr6d.f90:63-89`` and the ``propensities``
sections of ``reference/models/*.input``).

This module detects the factorization symbolically on the compiled
expression AST (models/expressions.py) and materializes per-species
*factor tables* ``t_{k,s}[v] = f_{k,s}(v)`` over a bounded coordinate
range.  The tables turn propensity evaluation from per-cell expression
re-evaluation (divisions, powers — the VPU bottleneck of the round-1
stencil kernels) into rank-1 broadcast products:

  * the XLA stencil evaluates the whole propensity field over a box as an
    outer product of d tiny per-axis vectors (d multiplies per cell,
    fused by XLA into the matvec);
  * the Pallas kernel bakes the factors of low-bit species into small
    periodic (P, 128) lane *patterns* (precomputed, zero per-cell cost)
    and evaluates only high-bit species factors per block row.

FSP truncation (source-state validity) folds into *shifted* tables
``u_{k,s}[v] = f_{k,s}(v - nu_{k,s})`` zeroed outside the box, so the
matvec needs no per-cell validity arithmetic at all (the reference drops
out-of-projection targets via ADJ=0, StateSpace.f90:235).

Every factorization is verified numerically against the model's own
propensity evaluation on a random state sample before use; a reaction
that does not factor (or fails verification) simply reports as
non-separable and callers fall back to direct evaluation.

PyTorch port of ``krylovfspssa_tpu/models/factorize.py``: the tables stay
numpy; expressions are evaluated by the port's torch evaluator on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from .expressions import BinOp, Neg, Node, Num, _eval_node, free_variables


def _eval_numpy(node: Node, env: dict) -> np.ndarray:
    """Evaluate an AST on numpy arrays / floats through the torch
    evaluator (float64 on the CPU); returns a numpy array."""
    tenv = {
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for k, v in env.items()
    }
    out = _eval_node(node, tenv)
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return np.asarray(out, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ReactionFactors:
    """a_k(x) = const * prod_{s in factors} eval(factors[s], x_s)."""

    const: float
    #: species index -> factor AST (free variables: that species + params)
    factors: dict[int, Node]


def _split_atoms(node: Node, inverted: bool, out: list):
    """Flatten a multiplicative expression into (atom, inverted) pairs."""
    if isinstance(node, BinOp) and node.op == "*":
        _split_atoms(node.lhs, inverted, out)
        _split_atoms(node.rhs, inverted, out)
    elif isinstance(node, BinOp) and node.op == "/":
        _split_atoms(node.lhs, inverted, out)
        _split_atoms(node.rhs, not inverted, out)
    elif isinstance(node, Neg):
        out.append((Num(-1.0), False))
        _split_atoms(node.arg, inverted, out)
    else:
        out.append((node, inverted))


def factorize_reaction(
    ast: Node,
    species_names: list[str],
    param_env: dict[str, float],
) -> ReactionFactors | None:
    """Split a propensity AST into per-species factors, or None.

    Returns None when any multiplicative atom references two or more
    species (a genuinely non-separable propensity, e.g. ``c*(x1+x2)``).
    Atoms referencing no species are evaluated numerically with the
    parameter values and folded into the constant.
    """
    species = set(species_names)
    atoms: list[tuple[Node, bool]] = []
    _split_atoms(ast, False, atoms)

    const = 1.0
    per_species: dict[int, Node] = {}
    for atom, inv in atoms:
        refs = free_variables(atom) & species
        if len(refs) > 1:
            return None
        if not refs:
            try:
                v = float(_eval_numpy(atom, param_env))
            except Exception:
                return None
            if v == 0.0 and inv:
                return None
            const = const / v if inv else const * v
            continue
        s = species_names.index(next(iter(refs)))
        factor = BinOp("/", Num(1.0), atom) if inv else atom
        if s in per_species:
            per_species[s] = BinOp("*", per_species[s], factor)
        else:
            per_species[s] = factor
    return ReactionFactors(const=const, factors=per_species)


def factorize_model(model) -> list[ReactionFactors] | None:
    """Factorize every reaction of an expression model (None for custom
    propensities or if any reaction is non-separable / unverifiable)."""
    if getattr(model, "custom_propensity", None) is not None:
        return None
    try:
        fns = model._ensure_compiled()
    except Exception:
        return None
    param_env = {
        name: float(v)
        for name, v in zip(model.parameter_names, np.asarray(model.parameters))
    }
    names = list(model.species_names)
    out = []
    for k in range(model.n_reactions):
        ast = getattr(fns[k], "ast", None)
        if ast is None:
            return None
        fz = factorize_reaction(ast, names, param_env)
        if fz is None:
            return None
        out.append(fz)
    if not _verify(model, out):
        return None
    return out


def factor_table(
    fz: ReactionFactors, species: int, extent: int, model
) -> np.ndarray:
    """t_{k,s}[v] = f_{k,s}(v) for v in [0, extent), float64 (ones if the
    reaction does not reference the species)."""
    node = fz.factors.get(species)
    if node is None:
        return np.ones(extent, dtype=np.float64)
    env = {
        name: float(v)
        for name, v in zip(model.parameter_names, np.asarray(model.parameters))
    }
    env[model.species_names[species]] = np.arange(extent, dtype=np.float64)
    vals = _eval_numpy(node, env)
    return np.broadcast_to(np.asarray(vals, dtype=np.float64), (extent,)).copy()


def shifted_factor_table(
    fz: ReactionFactors, species: int, extent: int, nu: int, model
) -> np.ndarray:
    """u_{k,s}[v] = f_{k,s}(v - nu) with zeros where v - nu is outside
    [0, extent) — the factor of the *source* state indexed by the
    destination coordinate, with FSP validity baked in."""
    t = factor_table(fz, species, extent, model)
    u = np.zeros(extent, dtype=np.float64)
    v = np.arange(extent)
    src = v - nu
    ok = (src >= 0) & (src < extent)
    u[ok] = t[src[ok]]
    return u


def _verify(model, facts: list[ReactionFactors], n_samples: int = 256) -> bool:
    """Numerically check C*prod(tables) against the model's own propensity
    evaluation on a random sample of states."""
    rng = np.random.default_rng(12345)
    d = model.n_species
    states = rng.integers(0, 40, size=(n_samples, d)).astype(np.int64)
    ref = model.propensities(torch.from_numpy(states)).numpy()
    if ref.ndim == 1:
        ref = ref[:, None]
    for k, fz in enumerate(facts):
        val = np.full(n_samples, fz.const, dtype=np.float64)
        for s, node in fz.factors.items():
            env = {
                name: float(v)
                for name, v in zip(
                    model.parameter_names, np.asarray(model.parameters)
                )
            }
            env[model.species_names[s]] = states[:, s].astype(np.float64)
            val = val * _eval_numpy(node, env)
        r = ref[:, k]
        if not np.allclose(val, r, rtol=1e-9, atol=1e-12 + 1e-9 * np.abs(r).max()):
            return False
    return True
