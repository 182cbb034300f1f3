"""Krylov-FSP-SSA CME solver on the table backend (PyTorch port of
``krylovfspssa_tpu/solver.py``).

Host-side orchestration of the device work, replicating ``CME_SOLVE`` /
``DGEXPV_FSP`` (``reference/src/fsp/KrylovSolver.f90:7-653``):

  * initialization: seed states, operator assembly, 5 rounds of 1-step
    reachability (KrylovSolver.f90:130-134), first step size;
  * the main loop (default, ``config.fused_steps``): segments of up to
    ``max_steps_per_call`` attempted steps (krylov/advance.py
    make_table_advance_fn), with DROP_STATES applied on the device as a
    soft row mask; the host re-enters to
      - compact dropped rows, run SSA + 1-step expansion and rebuild the
        operator (the state table is host bookkeeping by design),
      - stream step records / write checkpoints,
      - stop at t_out.
    With ``fused_steps=False`` the host runs one attempted step at a time
    and compacts at each drop.

The state table is host numpy plus the native hash (statespace/table.py,
native.py); the operator, the probability vector, the Krylov basis and the
SSA walks live on the solve's device (``"cuda"`` by default, the CPU when
asked for by name).  The operator is the gather-ELL form (ops/operator.py,
ops/spmv.py), as the JAX package uses on CPU and GPU, or on request the
pencil form (ops/pencil.py) that the JAX package picks on TPU.  With a
mesh of ranks the solve is row-sharded (:class:`CmeSolver`).  Capacities are
power-of-two buckets, so device buffers are re-allocated only on bucket
growth; one Krylov basis is shared by every bucket's step function.

The SSA walks draw from a ``torch.Generator`` of the solve's device that
the solver owns.  Its stream is keyed like the JAX package's: a 64-bit key
(two uint32 words, ``jax.random.PRNGKey``'s layout, from
``config.seed``) splits into the next key and one expansion's seed at
every expansion.  Checkpoints store the key as ``rng_state``, so a
snapshot resumes in either package; the two packages draw different
streams from one key.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import time
from typing import Sequence

import numpy as np
import torch

from .config import SolverConfig, resolve_solve_dtype
from .krylov.stepper import EPS, initial_carry
from .models.model import Model
from .ops.operator import build_operator
from .ops.spmv import spmv
from .statespace.drop import drop_loss_rate, drop_mask_device
from .statespace.encoding import StateEncoder
from .statespace.expand import onestep_extend, ssa_extend
from .statespace.table import StateTable
from .utils.stats import SolverStats, StepRecord
from .utils.trace import span

_DTYPES = {"float64": torch.float64, "float32": torch.float32}
_F64 = torch.float64
_M64 = (1 << 64) - 1
#: expansions in a row with no accepted step between them (once a step has
#: been accepted) after which a solve fails instead of expanding without
#: end (the box loops' growth-stall guard, boxsolver.py)
_MAX_STALLED_EXPANSIONS = 16


@dataclasses.dataclass
class SolveResult:
    """Final FSP and probability vector (the reference's FSP_OUT)."""

    states: np.ndarray  #: (n, d) int32
    probabilities: np.ndarray  #: (n,) float64
    t: float
    stats: SolverStats
    table: StateTable

    def probability(self, state) -> float:
        """Point probability lookup (POINTWISE_FSP parity,
        StateSpace.f90:96-114): 0 for states outside the projection."""
        idx = int(self.table.lookup_states(np.asarray(state)[None, :])[0])
        return float(self.probabilities[idx]) if idx >= 0 else 0.0

    @property
    def wsum(self) -> float:
        return float(self.probabilities.sum())

    def marginal(self, species: int) -> np.ndarray:
        """Marginal distribution of one species (utils/queries.py)."""
        from .utils.queries import marginal

        return marginal(self.states, self.probabilities, species)

    def mean(self) -> np.ndarray:
        from .utils.queries import mean

        return mean(self.states, self.probabilities)

    def variance(self) -> np.ndarray:
        from .utils.queries import variance

        return variance(self.states, self.probabilities)


class _EllVec:
    """Device-vector layout of the gather-ELL operator: vector index ==
    table row, padded to the capacity bucket.  Under ``mesh`` the device
    vectors are this rank's rows ``[z0, z0+L)`` of the capacity, and
    ``take``/``keep_rows`` gather the whole vector on every rank."""

    def __init__(self, table: StateTable, device, dtype, mesh=None):
        self._table = table
        self._device = device
        self._dtype = dtype
        self._mesh = mesh
        self.cells = table.capacity
        if mesh is None:
            self._rows = (0, self.cells)
        else:
            from .parallel.sharded import table_rows

            self._rows = table_rows(mesh, self.cells)

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        return t if self._mesh is None else self._mesh.gather(t)

    def put(self, w_rows: np.ndarray) -> torch.Tensor:
        out = np.zeros(self.cells, dtype=np.float64)
        out[: min(len(w_rows), self.cells)] = w_rows[: self.cells]
        z0, n = self._rows
        return torch.as_tensor(out[z0:z0 + n], device=self._device).to(
            self._dtype)

    def take(self, w: torch.Tensor) -> np.ndarray:
        return self._whole(w)[: self._table.n].to(_F64).cpu().numpy()

    def active0(self) -> torch.Tensor:
        z0, n = self._rows
        return torch.arange(z0, z0 + n, device=self._device) < self._table.n

    def keep_rows(self, cells: torch.Tensor) -> np.ndarray:
        return self._whole(cells)[: self._table.n].cpu().numpy()


class _PencilVec:
    """Device-vector layout of the pencil operator: vector index == pencil
    cell (rows x 128 lanes), padded to the rows bucket (ops/pencil.py)."""

    def __init__(self, layout, mask: np.ndarray, device, dtype):
        self.layout = layout
        self.cells = len(mask)
        self._device = device
        self._dtype = dtype
        self._mask = torch.as_tensor(mask, device=device)

    def put(self, w_rows: np.ndarray) -> torch.Tensor:
        out = np.zeros(self.cells, dtype=np.float64)
        out[self.layout.slot_of_state[: len(w_rows)]] = w_rows
        return torch.as_tensor(out, device=self._device).to(self._dtype)

    def take(self, w: torch.Tensor) -> np.ndarray:
        return w.to(_F64).cpu().numpy()[self.layout.slot_of_state]

    def active0(self) -> torch.Tensor:
        return self._mask.clone()

    def keep_rows(self, cells: torch.Tensor) -> np.ndarray:
        return cells.cpu().numpy()[self.layout.slot_of_state]


def _same_layout(vl, vl_new) -> bool:
    """Whether a vector of ``vl`` is one of ``vl_new`` as it stands: an
    ELL append within the same bucket (appended rows read as zero
    padding).  A pencil rebuild moves cells, so it never is."""
    return (isinstance(vl, _EllVec) and isinstance(vl_new, _EllVec)
            and vl_new.cells == vl.cells)


# ------------------------------------------------------------ SSA keys ----


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _key_of_seed(seed: int) -> np.ndarray:
    """The 64-bit SSA key of a seed, as two uint32 words (hi, lo): the
    layout of ``jax.random.PRNGKey(seed)``."""
    seed = int(seed) & _M64
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def _key_int(key) -> int:
    """A key array (the port's two words, or any other package's key) as
    one 64-bit integer."""
    words = np.asarray(key).astype(np.uint64).ravel()
    if words.size == 2 and int(words.max()) <= 0xFFFFFFFF:
        return (int(words[0]) << 32) | int(words[1])
    x = 0
    for v in words.tolist():
        x = _splitmix64(x ^ v)
    return x


def _split_key(key) -> tuple[np.ndarray, int]:
    """(next key, seed of one expansion's generator)."""
    nxt = _splitmix64(_key_int(key))
    return _key_of_seed(nxt), _splitmix64(nxt ^ 0xD1B54A32D192ED03)


# ---------------------------------------------------------------- solver --


class CmeSolver:
    """Reusable table-backend solver bound to one model and one device.

    ``device`` defaults to ``"cuda"``; the CPU runs only when asked for by
    name.  Pass ``mesh`` (a ``parallel.sharded.ShardMesh``; every rank
    calls ``solve`` with the same arguments) to run the whole solve with
    the state rows partitioned over the ranks: the gather-ELL operator,
    the probability vector, the active mask and the Krylov basis hold
    rank r's rows ``[r*cap/P, (r+1)*cap/P)``; a matvec all-gathers x, and
    every sum over the rows is an all_reduce.  The state table stays
    host-side on every rank, as the JAX package keeps it: rank 0 runs the
    SSA walks and broadcasts the rows they add, every rank merges them and
    runs the 1-step round, and a check after each expansion raises unless
    every rank holds the same table.  Drop compaction, growth, snapshots
    (rank 0 writes them, in the one-device format) and the result gather
    the whole vector.  ``config.table_operator``: "auto" and "ell" take
    the gather-ELL operator (the JAX package picks the pencil for "auto"
    only on TPU); any other value builds the pencil operator
    (ops/pencil.py), except under a mesh, where every value takes ELL, as
    in the JAX package.  ``config.warm_next_bucket`` (the JAX package's
    background compile of the next bucket) is accepted and ignored:
    nothing is compiled here.
    """

    def __init__(
        self,
        model: Model,
        config: SolverConfig | None = None,
        mesh=None,
        device=None,
    ):
        self.model = model
        self.config = config or SolverConfig()
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if mesh is None:
            self._spmv = spmv
        else:
            from .parallel.sharded import sharded_matvec

            self._spmv = sharded_matvec(mesh)
        self._pencil_lane = None
        self.encoder = StateEncoder.for_model(
            model.n_species, self.config.max_molecules
        )
        self._stoich = np.asarray(model.stoichiometry, dtype=np.int64)
        self._props_fn = None
        #: the SSA walks' generator (re-seeded at each expansion from the
        #: key chain, module docstring)
        self.generator = torch.Generator(device=self.device)
        self._key = _key_of_seed(self.config.seed)
        self._dtype = None
        #: the Krylov basis, shared by every capacity bucket's step
        #: function so that one basis is alive at a time
        self._basis: dict = {}
        self._steps: dict = {}
        self._set_dtype(self.config.resolved_dtype(self.device))

    @property
    def dtype(self) -> torch.dtype:
        """The vector dtype of the current (or last) solve."""
        return self._dtype

    def _set_dtype(self, name: str):
        """(Re-)resolve the solve dtype (the f32 tolerance contract may
        force float64 for a tight fsp_tol); drop per-dtype caches."""
        dt = _DTYPES[name]
        if dt is self._dtype:
            return
        self._dtype = dt
        self._steps = {}
        self._basis.clear()

    def _m_eff(self, capacity: int) -> int:
        """m_max clamped so the Krylov basis ((m_max+2, capacity)) fits
        config.max_basis_bytes."""
        cfg = self.config
        m_eff = cfg.m_max
        if cfg.max_basis_bytes > 0:
            itemsize = torch.empty((), dtype=self._dtype).element_size()
            mh = int(cfg.max_basis_bytes // (capacity * itemsize))
            m_eff = min(cfg.m_max, max(cfg.m_min, mh - 2))
        return m_eff

    def _cfg_eff(self, m_eff: int) -> SolverConfig:
        cfg = self.config
        return cfg if m_eff == cfg.m_max else dataclasses.replace(
            cfg, m_max=m_eff
        )

    def _advance(self, capacity: int, budget: int):
        """The fused segment function of a capacity bucket
        (krylov/advance.py make_table_advance_fn)."""
        from .krylov.advance import make_table_advance_fn

        m_eff = self._m_eff(capacity)
        key = ("adv", m_eff, budget)
        if key not in self._steps:
            self._steps[key] = make_table_advance_fn(
                self._cfg_eff(m_eff), budget,
                max_states=self.config.max_states, basis=self._basis,
                mesh=self.mesh,
            )
        return self._steps[key]

    def _step(self, op_active, w, *args):
        """One attempted step of the stepwise loop: the masked step of the
        fused loop (krylov/advance.py make_masked_table_step), so both
        loops run the same arithmetic."""
        from .krylov.advance import make_masked_table_step

        m_eff = self._m_eff(self._cells(w))
        if m_eff not in self._steps:
            self._steps[m_eff] = make_masked_table_step(
                self._cfg_eff(m_eff), basis=self._basis, mesh=self.mesh
            )
        return self._steps[m_eff](op_active, w, *args)

    # ------------------------------------------------------------------ #

    def _cells(self, w: torch.Tensor) -> int:
        """The whole vector's length (every rank's rows under a mesh): the
        basis clamp counts it, so m_eff is the one-device solve's."""
        return w.shape[0] * (1 if self.mesh is None else self.mesh.size)

    def _total(self, t):
        """A float64 sum over the rows: over every rank under a mesh."""
        return t if self.mesh is None else self.mesh.sum(t)

    def _choose_operator(self, table: StateTable):
        """Resolve config.table_operator, as the JAX package does off TPU:
        "ell", "auto" and any value under a mesh take the gather-ELL
        operator; any other value the pencil operator, laid along
        ``config.pencil_lane_species`` (default: the species of largest
        extent in the current states)."""
        cfg = self.config
        self._pencil_lane = None
        mode = cfg.table_operator
        if mode in ("ell", "auto") or self.mesh is not None:
            return
        lane = cfg.pencil_lane_species
        if lane is None:
            lane = int(np.argmax(table.states[: table.n].max(axis=0)))
        self._pencil_lane = int(lane)

    def _operator(self, table: StateTable):
        """(operator, vector layout) for the current state set: the table's
        arrays go to the device once, and the operator is built there (this
        rank's rows of it under a mesh)."""
        if self._pencil_lane is not None:
            op, vl = self._pencil_operator(table)
            tensors = op.tensors()
        else:
            dev = self.device
            vl = _EllVec(table, dev, self._dtype, self.mesh)
            op = build_operator(
                torch.as_tensor(table.states, device=dev),
                torch.as_tensor(table.sorted_keys, device=dev),
                torch.as_tensor(table.sorted_to_row, device=dev),
                table.n, self._props_fn, self._stoich, self.encoder,
                self._dtype, rows=None if self.mesh is None else vl._rows,
            )
            tensors = tuple(op)
        if self.device.type == "cuda" and not all(t.is_cuda for t in tensors):
            raise RuntimeError("table operator built off the card: "
                               f"{[t.device for t in tensors]}")
        return op, vl

    def _pencil_operator(self, table: StateTable):
        """The pencil operator: the host builds the small index tables
        (layout and source rows), padded to a rows bucket; the per-cell
        fields are built on the device (ops/pencil.py)."""
        from .ops.pencil import (
            LANES,
            build_pencil_layout,
            host_index_tables,
            make_pencil_operator_builder,
        )

        lane = self._pencil_lane
        layout = build_pencil_layout(table.states[: table.n], lane)
        src_a, src_b = host_index_tables(layout, self._stoich)
        rows = layout.n_rows
        rows_b = max(64, 1 << int(np.ceil(np.log2(max(rows, 1)))))
        R = self._stoich.shape[0]
        row_base_p = np.full(rows_b, -1, np.int32)
        row_base_p[:rows] = layout.row_base
        row_block_p = np.zeros(rows_b, np.int32)
        row_block_p[:rows] = layout.row_block
        src_a_p = np.full((R, rows_b), -1, np.int32)
        src_a_p[:, :rows] = src_a
        src_b_p = np.full((R, rows_b), -1, np.int32)
        src_b_p[:, :rows] = src_b
        cells = rows_b * LANES
        mask_p = np.zeros(cells, bool)
        mask_p[: rows * LANES] = layout.mask.reshape(-1)

        key = ("pencil_build", lane)
        if key not in self._steps:
            self._steps[key] = make_pencil_operator_builder(
                self.model, self._stoich, lane, self.encoder.species_cap,
                self._dtype, self.device, params=self._props_fn.keywords[
                    "params"],
            )
        op = self._steps[key](layout.bases, row_base_p, row_block_p, src_a_p,
                              src_b_p, mask_p, table.n)
        return op, _PencilVec(layout, mask_p, self.device, self._dtype)

    def _check_table(self, table: StateTable):
        """Raise unless every rank of the mesh holds the same table: its
        row count, capacity and a SHA-1 of its rows, gathered as int64."""
        digest = hashlib.sha1(
            np.ascontiguousarray(table.states[: table.n]).tobytes()
        ).digest()
        mine = torch.tensor(
            [table.n, table.capacity,
             *np.frombuffer(digest[:16], dtype=np.int64).tolist()],
            dtype=torch.int64, device=self.mesh.device)
        every = self.mesh.gather(mine).cpu().reshape(self.mesh.size, -1)
        if not bool((every == every[0]).all()):
            raise RuntimeError(
                "the ranks' state tables differ after an expansion "
                f"(rank: n, capacity, digest = {every.tolist()}): every rank "
                "must merge the same rows in the same order"
            )

    def _ssa_extend(self, table: StateTable, t_ssa) -> tuple:
        """SSA expansion of the table.  Under a mesh rank 0 runs the walks
        (``ssa_extend``) and broadcasts the rows they appended; every other
        rank appends them in the same order."""
        cfg = self.config
        args = (self._props_fn, self._stoich, float(t_ssa), self.generator,
                cfg.ssa_max_steps, cfg.max_states)
        mesh = self.mesh
        if mesh is None:
            return ssa_extend(table, *args)
        n0 = table.n
        if mesh.rank == 0:
            table, _ = ssa_extend(table, *args)
        m = int(mesh.broadcast(torch.tensor([table.n - n0])).item())
        if m == 0:
            return table, 0
        W = self.encoder.n_words
        d = self.model.n_species
        if mesh.rank == 0:
            keys = torch.as_tensor(table.keys[n0:n0 + m])
            states = torch.as_tensor(table.states[n0:n0 + m])
        else:
            keys = torch.zeros((m,) if W == 1 else (m, W), dtype=torch.int64)
            states = torch.zeros((m, d), dtype=torch.int32)
        keys = mesh.broadcast(keys).cpu().numpy()
        states = mesh.broadcast(states).cpu().numpy()
        if mesh.rank != 0:
            table, _ = table.merge_keys(keys, states, cfg.max_states)
        return table, m

    def _expand(self, table, t_ssa, carry, t_out, fsptol):
        """SSA + 1-step expansion (KrylovSolver.f90:516-534) on the device
        generator, with this expansion's seed from the key chain.

        Raises ``RuntimeError`` at the ``_MAX_STALLED_EXPANSIONS``-th
        expansion in a row at one ``t_now`` once a step has been accepted:
        states added with zero probability cannot move the mass, so a
        criterion that no step meets (e.g. mass at the two-sided
        criterion's ceiling) would otherwise expand the table without
        end."""
        cfg = self.config
        t_now = float(carry.t_now)
        self._stalled = self._stalled + 1 if t_now == self._t_expand else 1
        self._t_expand = t_now
        if self._stalled >= _MAX_STALLED_EXPANSIONS and int(carry.nstep) >= 1:
            b = fsptol * t_now / abs(float(t_out))
            raise RuntimeError(
                f"{self._stalled} consecutive state-space expansions without "
                f"an accepted step at t={t_now:g} (n={table.n}, wsum "
                f"{float(carry.wsum_old):.12g}, FSP criterion 1 +- {b:.6g} "
                "and growing with t): the criterion cannot be met — mass "
                "above 1 at its ceiling, or fsp_tol unattainable at this "
                "precision (KrylovSolver.f90:442-495)"
            )
        self._key, seed = _split_key(self._key)
        self.generator.manual_seed(seed)
        table, added_ssa = self._ssa_extend(table, t_ssa)
        table, added_1s = onestep_extend(table, self._stoich, cfg.max_states)
        if self.mesh is not None:
            self._check_table(table)
        return table, added_ssa, added_1s

    def solve(
        self,
        t: float,
        initial_states: Sequence[Sequence[int]] | None = None,
        p0: Sequence[float] | None = None,
        fsp_tol: float = 1e-4,
        krylov_tol: float = 1e-10,
        verbosity: int | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 50,
        resume_from: str | None = None,
    ) -> SolveResult:
        """Solve dp/dt = A p from the initial distribution to time ``t``.

        Args:
          t: final time (T_OUT).
          initial_states: (k, d) seed states of the projection.
          p0: (k,) initial probabilities (default: delta at the first state,
            the drivers' ``p0(1)=1`` convention, TestSolverFromFile.f90:29).
          fsp_tol: total FSP truncation error budget (FSPTOL).
          krylov_tol: local Krylov error tolerance (EXP_TOL/KRYTOL).
          checkpoint_path / checkpoint_every: write a resumable snapshot
            every N accepted steps.
          resume_from: continue from a table-backend snapshot of either
            package (t, tolerances and the SSA key come from the snapshot).
        """
        cfg = self.config
        verbosity = cfg.verbosity if verbosity is None else verbosity
        wall0 = time.perf_counter()
        dev_type = self.device.type
        self._stalled, self._t_expand = 0, None
        # the model's parameters on the device once per solve: the SSA
        # walks evaluate the propensities at every jump
        params = torch.as_tensor(np.asarray(self.model.parameters),
                                 dtype=_F64, device=self.device)
        self._props_fn = functools.partial(self.model.propensities,
                                           params=params)

        if resume_from is not None:
            from .checkpoint import load_table_checkpoint

            (states_ck, w_ck, carry, t, fsp_tol, krytol, rng_state) = (
                load_table_checkpoint(resume_from)
            )
            self._set_dtype(resolve_solve_dtype(
                cfg, float(fsp_tol), dev_type, krylov_tol=float(krytol)
            ))
            table = StateTable.from_states(
                states_ck, self.encoder, cfg.init_capacity, cfg.max_states,
                device=self.device,
            )
            self._choose_operator(table)
            op, vl = self._operator(table)
            w = vl.put(np.asarray(w_ck, np.float64))
            self._key = _key_of_seed(_key_int(rng_state))
        else:
            if initial_states is None:
                raise ValueError("initial_states required unless resuming")
            self._set_dtype(resolve_solve_dtype(
                cfg, float(fsp_tol), dev_type, krylov_tol=float(krylov_tol)
            ))
            init = np.atleast_2d(np.asarray(initial_states, dtype=np.int32))
            if p0 is None:
                p0 = np.zeros(init.shape[0])
                p0[0] = 1.0
            p0 = np.asarray(p0, dtype=np.float64)

            table = StateTable.from_states(
                init, self.encoder, cfg.init_capacity, cfg.max_states,
                device=self.device,
            )
            # start-up expansion (KrylovSolver.f90:130-134)
            for _ in range(cfg.init_onestep_expansions):
                table, _ = onestep_extend(table, self._stoich, cfg.max_states)
            w_rows = np.zeros(table.n, dtype=np.float64)
            w_rows[table.lookup_states(init)] = p0

            self._choose_operator(table)
            op, vl = self._operator(table)
            w = vl.put(w_rows)

            # tolerance floor (KrylovSolver.f90:171)
            krytol = float(krylov_tol)
            if krytol <= EPS:
                krytol = float(np.sqrt(EPS))

            beta = float(np.linalg.norm(w_rows))
            if beta == 0.0:
                raise ValueError("initial probability vector is zero")
            carry = initial_carry(beta, abs(t), krytol, cfg.anorm, cfg.m_min)
            self._key = _key_of_seed(cfg.seed)

        t_out = float(t)
        fsptol = float(fsp_tol)
        krytol = float(krytol)
        stats = SolverStats()
        hard_cap = cfg.mxstep if cfg.mxstep > 0 else 1_000_000
        last_ckpt = [int(carry.nstep)]

        def maybe_checkpoint(table_, w_rows_fn, carry_, keep=None):
            # w_rows_fn: lazy () -> (n,) float64 table-row vector (the
            # D2H copy happens only when a snapshot is due)
            if checkpoint_path is None:
                return
            nstep = int(carry_.nstep)
            if nstep - last_ckpt[0] >= int(checkpoint_every):
                from .checkpoint import save_table_checkpoint

                states_ck = table_.states[: table_.n]
                w_ck = w_rows_fn()
                if keep is not None and not keep.all():
                    states_ck = states_ck[keep]
                    w_ck = w_ck[keep]
                # every rank gathers w; one writes the snapshot
                if self.mesh is None or self.mesh.rank == 0:
                    save_table_checkpoint(
                        checkpoint_path, states_ck, w_ck, carry_, t_out,
                        fsptol, krytol, self._key,
                    )
                last_ckpt[0] = nstep

        if cfg.fused_steps:
            budget = cfg.max_steps_per_call
            if checkpoint_path is not None:
                budget = min(budget, int(checkpoint_every))
            table, w_rows, carry = self._solve_fused(
                table, w, vl, carry, t_out, fsptol, krytol, stats, hard_cap,
                verbosity, op, maybe_checkpoint, budget,
            )
            return self._finalize(table, w_rows, carry, stats, t_out, wall0)

        iteration = 0
        nan_resets = 0
        while float(carry.t_now) < abs(t_out):
            iteration += 1
            if iteration > hard_cap:
                stats.nstep = int(carry.nstep)
                raise RuntimeError(
                    f"exceeded {hard_cap} attempted steps (IFLAG=1 analog)"
                )

            active = vl.active0()
            res = self._step((op, active), w, carry, t_out, fsptol, krytol)
            w, carry = res.w, res.carry
            if int(carry.iflag) == 3:
                # persistent-NaN step (poisoned controller scalars).  The
                # vector is clean on this path (the stepper reverts w to
                # beta*v1), so sanitize the carry from w and retry; only a
                # sixth failure is fatal
                carry = self._sanitize_carry(carry, w, t_out, krytol)
                nan_resets += 1
                if nan_resets > 5:
                    self._fail(3)
                if verbosity:
                    print(f"NaN step at t={float(carry.t_now):g}; "
                          "controller state reset", flush=True)
                continue
            if int(carry.iflag) == 2:
                self._fail(2)
            dropped = 0

            # ---- drop surplus mass (KrylovSolver.f90:509-511) ----------
            if res.advanced and res.dsum > 0.0:
                w64 = w.to(_F64)
                inflow = self._spmv(op, w).to(_F64)
                reduce = None if self.mesh is None else self.mesh.sum
                mask, count, _ = drop_mask_device(
                    w64, inflow, active, res.dsum,
                    droptol_start=cfg.droptol_start,
                    inflow_guard=cfg.inflow_guard, reduce=reduce,
                )
                # anti-thrash gate, the fused loop's policy (drop_inline):
                # commit only when the drop set's gross leak rate fits the
                # scaled FSP budget rate, unless under memory pressure
                loss_rate = drop_loss_rate(w64, inflow, op.diag.to(_F64),
                                           mask, reduce)
                rate_budget = cfg.drop_rate_frac * fsptol / abs(t_out)
                pressure = cfg.max_states is not None and (
                    table.n >= cfg.drop_pressure_frac * cfg.max_states
                )
                if count > cfg.drop_fraction * table.n and (
                    loss_rate <= rate_budget or pressure
                ):
                    keep = ~vl.keep_rows(mask)
                    w_rows = vl.take(w)
                    dropped_mass = float(w_rows[~keep].sum())
                    w_kept = w_rows[keep]
                    table, _ = table.compact(keep)
                    op, vl = self._operator(table)
                    w = vl.put(w_kept)
                    dropped = count
                    stats.n_drops += 1
                    beta_new = float(np.linalg.norm(w_kept))
                    carry = carry._replace(
                        beta=np.float64(beta_new),
                        hump=np.maximum(carry.hump, beta_new),
                        spent=carry.spent + dropped_mass,
                    )

            # ---- SSA + 1-step expansion (KrylovSolver.f90:516-534) -----
            if res.iexpand and float(carry.t_now) < abs(t_out):
                n_before = table.n
                w_rows = vl.take(w)
                table, _, _ = self._expand(table, res.t_ssa, carry, t_out,
                                           fsptol)
                if table.n != n_before:
                    w_rows = np.concatenate(
                        [w_rows, np.zeros(table.n - n_before)]
                    )
                    op, vl_new = self._operator(table)
                    if not _same_layout(vl, vl_new):
                        # layout changed (pencil re-slotting or capacity
                        # growth): re-place the vector; appended states
                        # carry probability zero
                        w = vl_new.put(w_rows)
                    vl = vl_new
                stats.n_expansions += 1

            rec = StepRecord(
                nstep=int(carry.nstep),
                fsp_size=table.n,
                t_step=res.t_step,
                t_new=float(carry.t_new),
                t_now=float(carry.t_now),
                m=int(res.m_used),
                wsum=res.wsum,
                err_loc=res.err_loc,
                advanced=res.advanced,
                expanded=res.iexpand,
                dropped=dropped,
            )
            stats.records.append(rec)
            if verbosity:
                print(rec.format(), flush=True)
            maybe_checkpoint(table, lambda: vl.take(w), carry)

        return self._finalize(table, vl.take(w), carry, stats, t_out, wall0)

    def _fail(self, iflag: int):
        """Raise the failure of a step with iflag 3 (after five resets) or
        2."""
        if iflag == 3:
            raise RuntimeError(
                "local Krylov error stayed NaN through the bounded tau/5 "
                "retry (iflag=3) five times — basis/H numerically "
                "corrupted (inf/NaN propensity, overscaled expm, or "
                "device-state corruption); inspect the operator"
            )
        raise RuntimeError(
            f"step rejected more than mxreject={self.config.mxreject} times "
            "(IFLAG=2, KrylovSolver.f90:392-397); requested tolerance "
            "likely unattainable"
        )

    def _sanitize_carry(self, carry, w, t_out, krytol):
        """Rebuild the controller scalars of a NaN-poisoned carry from the
        (clean) probability vector: a fresh step size, reset adaptivity
        history, counters kept."""
        cfg = self.config
        beta = math.sqrt(float(self._total(torch.sum(w.to(_F64) ** 2))))
        remaining = abs(float(t_out)) - float(carry.t_now)
        fresh = initial_carry(beta, remaining, krytol, cfg.anorm, cfg.m_min)
        return carry._replace(
            t_new=carry.t_new if math.isfinite(float(carry.t_new))
            else fresh.t_new,
            beta=np.float64(beta),
            omega=fresh.omega,
            t_old=fresh.t_old,
            m_old=fresh.m_old,
            order=fresh.order,
            kfactor=fresh.kfactor,
            orderold=fresh.orderold,
            kestold=fresh.kestold,
            iflag=np.int32(0),
        )

    def _finalize(self, table, w_rows, carry, stats, t, wall0) -> SolveResult:
        # ---- final statistics (KrylovSolver.f90:554-573) ---------------
        stats.nmult = int(carry.nmult)
        stats.nexph = int(carry.nexph)
        stats.nscale = int(carry.nscale)
        stats.nstep = int(carry.nstep)
        stats.nreject = int(carry.nreject)
        stats.ibrkflag = int(carry.ibrkflag)
        stats.iflag = int(carry.iflag)
        stats.mbrkdwn = int(carry.mbrkdwn)
        stats.tbrkdwn = float(carry.tbrkdwn)
        stats.step_min = float(carry.step_min)
        stats.step_max = float(carry.step_max)
        stats.x_error = float(carry.x_error)
        stats.s_error = float(carry.s_error)
        stats.t_final = float(carry.t_now)
        stats.mass_spent = float(carry.spent)
        stats.hump_ratio = float(carry.hump / carry.vnorm)
        stats.final_norm_ratio = float(carry.beta / carry.vnorm)
        stats.final_fsp_size = table.n
        stats.wall_s = time.perf_counter() - wall0

        # report clipped probabilities (the f32 path keeps the signed
        # vector in-solve to avoid accumulating clip bias)
        w_final = np.maximum(np.asarray(w_rows, dtype=np.float64), 0.0)
        return SolveResult(
            states=table.states[: table.n].copy(),
            probabilities=w_final,
            t=float(t),
            stats=stats,
            table=table,
        )

    def _solve_fused(
        self, table, w, vl, carry, t, fsptol, krytol, stats, hard_cap,
        verbosity, op, maybe_checkpoint, budget,
    ):
        """Fused main loop of the table backend: segments of
        krylov/advance.py make_table_advance_fn; the host re-enters on
        expansion events, the segment budget, completion and failure.
        Soft-dropped rows are compacted out of the host table at expansion
        events and at the end."""
        from .krylov.advance import EVENT_DONE, EVENT_EXPAND, EVENT_FAIL
        from .krylov.advance import RECORD_FIELDS

        total_attempted = 0
        nan_resets = 0
        active = vl.active0()
        while True:
            # resume at completion (t_now >= t_out, e.g. a snapshot
            # written on the final step): nothing to integrate
            if float(carry.t_now) >= abs(float(t)):
                break
            adv = self._advance(vl.cells, budget)
            with span("segment"):
                st = adv(op, w, active, carry, t, fsptol, krytol)
            w, active, carry = st.w, st.active, st.carry
            nsteps = st.steps
            total_attempted += nsteps
            stats.n_drops += st.n_drops
            for row in st.records:
                rec = StepRecord(**dict(zip(RECORD_FIELDS, row)))
                stats.records.append(rec)
                if verbosity:
                    print(rec.format(), flush=True)
            keep = vl.keep_rows(active)
            maybe_checkpoint(table, lambda: vl.take(w), carry, keep)
            if st.event == EVENT_FAIL:
                if int(carry.iflag) == 3:
                    # recoverable: sanitize the poisoned controller scalars
                    # from the clean vector and re-enter (see the stepwise
                    # loop)
                    nan_resets += 1
                    if nan_resets > 5:
                        self._fail(3)
                    carry = self._sanitize_carry(carry, w, t, krytol)
                    if verbosity:
                        print(f"NaN step at t={float(carry.t_now):g}; "
                              "controller state reset", flush=True)
                    continue
                self._fail(2)
            if st.event == EVENT_DONE:
                break
            if total_attempted > hard_cap:
                stats.nstep = int(carry.nstep)
                raise RuntimeError(
                    f"exceeded {hard_cap} attempted steps (IFLAG=1 analog)"
                )
            if st.event == EVENT_EXPAND:
                # host mutation: compact soft-dropped rows, then SSA +
                # 1-step expansion and operator rebuild
                # (KrylovSolver.f90:516-534)
                n_before = table.n
                w_rows = vl.take(w)
                # every path out of the stepper leaves ~unit mass (accepted
                # steps satisfy the FSP criterion; abandoned steps revert
                # to beta*v1): a gross violation means corrupted device
                # state, so fail instead of expanding without end
                wsum_host = float(w_rows.sum())
                if not 0.5 < wsum_host < 1.5:
                    raise RuntimeError(
                        f"probability mass {wsum_host:.6g} at a host "
                        f"re-entry (t={float(carry.t_now):g}, n={table.n}, "
                        f"capacity={table.capacity}) — device state "
                        "corrupted"
                    )
                compacted = not keep.all()
                if compacted:
                    w_rows = w_rows[keep]
                    table, _ = table.compact(keep)
                table, added_ssa, added_1s = self._expand(
                    table, st.t_ssa, carry, t, fsptol)
                if verbosity >= 2:
                    print(
                        f"EXPAND t={float(carry.t_now):g} wsum={wsum_host:.9f}"
                        f" n {n_before}->{table.n} (+{added_ssa} ssa, "
                        f"+{added_1s} 1-step) cap {table.capacity} "
                        f"t_ssa={st.t_ssa:g}"
                        + (" [compacted]" if compacted else ""),
                        flush=True,
                    )
                if compacted or table.n != len(w_rows):
                    w_rows = np.concatenate(
                        [w_rows, np.zeros(table.n - len(w_rows))]
                    )
                    op, vl_new = self._operator(table)
                    if compacted or not _same_layout(vl, vl_new):
                        # re-place the vector unless the row layout is
                        # unchanged (an ELL append within the same bucket:
                        # appended states already read as zero padding)
                        w = vl_new.put(w_rows)
                    vl = vl_new
                active = vl.active0()
                stats.n_expansions += 1
            # EVENT_BUDGET: stream records / checkpoint and re-enter

        # drop soft-dropped rows from the final table (their probability
        # is already zero; the stepwise loop compacts at drop time)
        keep = vl.keep_rows(active)
        w_rows = vl.take(w)
        if not keep.all():
            w_rows = w_rows[keep]
            table, _ = table.compact(keep)
        return table, w_rows, carry


def solve_cme(
    model: Model,
    t: float,
    initial_states,
    p0=None,
    fsp_tol: float = 1e-4,
    krylov_tol: float = 1e-10,
    config: SolverConfig | None = None,
    verbosity: int = 0,
    mesh=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 50,
    resume_from: str | None = None,
    device=None,
) -> SolveResult:
    """Solve the CME of ``model`` to time ``t`` on the table backend
    (:class:`CmeSolver`; CME_SOLVE parity).  ``device`` defaults to
    ``"cuda"``; with ``mesh`` the solve is row-sharded and every rank of
    the mesh calls this with the same arguments (every rank returns the
    whole result)."""
    with span("solve"):
        solver = CmeSolver(model, config, mesh=mesh, device=device)
        return solver.solve(
            t, initial_states, p0, fsp_tol, krylov_tol, verbosity=verbosity,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, resume_from=resume_from,
        )
