"""Krylov-FSP-SSA solver on the masked-box backend (PyTorch port of
``krylovfspssa_tpu/boxsolver.py``).

The FSP lives in a masked power-of-two box (boxspace/box.py) and the
operator is the matrix-free stencil (ops/stencil.py; on CUDA the
hand-written kernels of ops/stencil_cuda.py).  State-set mutation is
elementwise device work:

  * drop            -> clear mask bits (no compaction, no re-indexing)
  * 1-step expand   -> dilate the mask by the legal-move stencil
  * SSA expansion   -> K dilation rounds (the shell after K rounds contains
                       every K-jump SSA path; the FSP criterion + drop trim
                       the surplus) — a deterministic replacement for the
                       reference's serial Gillespie walks
                       (StateSpace.f90:550-630), so this backend draws no
                       random numbers
  * box growth      -> double one axis when active cells touch its face

The port runs the host-driven stepwise loop of the JAX package
(``BoxCmeSolver.solve`` with ``fused_steps=False``) whatever
``config.fused_steps`` says.  That is the same algorithm as the JAX fused
device loop (``tests/test_box.py::test_fused_loop_matches_host_loop`` pins
the two equal); a fused device loop for this port is later work.

With ``mesh`` (parallel/sharded.py) the solve is row-sharded: every rank
of the mesh calls ``solve`` with the same arguments, holds its rows of the
mask, the vector and the Krylov basis, and runs the same host loop on
scalars that are reduced over the ranks, so every rank takes the same
branches.  The matvec exchanges halos (ops/halo.py); box growth gathers
the mask and the vector to every rank, grows and re-slices them, as the
JAX package does with ``host_gather``.  Every rank returns the whole
result.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from .boxspace.box import BoxSpace
from .config import SolverConfig, resolve_solve_dtype
from .krylov.stepper import EPS, initial_carry, make_step_fn
from .models.model import Model
from .ops.stencil import (
    active_touches_face,
    expansion_rounds,
    make_diag_fn,
    make_dilate_fn,
    select_stencil_matvec,
)
from .parallel.multihost import host_gather
from .statespace.drop import drop_loss_rate, drop_mask_device
from .utils.stats import SolverStats, StepRecord

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass
class BoxSolveResult:
    """Final FSP (active cells of the box) and probability vector."""

    states: np.ndarray  #: (n, d) int32 active states
    probabilities: np.ndarray  #: (n,) float64
    t: float
    stats: SolverStats
    box: BoxSpace
    mask: np.ndarray  #: flat bool
    w_flat: np.ndarray  #: flat float64

    def probability(self, state) -> float:
        idx = int(self.box.flat_index(np.asarray(state)[None, :])[0])
        if idx < 0 or not self.mask[idx]:
            return 0.0
        return float(self.w_flat[idx])

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


@dataclasses.dataclass(frozen=True)
class _GeometryFns:
    """Per-box-geometry operator pieces (built once per box shape)."""

    step: object
    matvec: object
    diag: object
    dilate: object


class BoxCmeSolver:
    """Reusable box-backend solver bound to one model and one device.

    ``device`` defaults to ``"cuda"``; the CPU runs only when asked for
    by name.  On CUDA the stencil matvec is a hand-written kernel, in
    float32 and float64: ``box_stencil`` for separable models,
    ``direct_stencil`` for the rest (custom propensities, coupled
    expressions).  On the CPU it is the plain PyTorch version.

    Per box geometry the direct form keeps its diagonal and R rate fields
    on the device ((R + 1) * volume * itemsize bytes: 738 MB for ge5d,
    R=10, at 2^23 cells in float64).  The basis clamp of :meth:`_geometry_config` does
    not count them, as in the JAX package.

    Pass ``mesh`` (a ``parallel.sharded.ShardMesh``) to run the solve
    row-sharded over its ranks, one process each (module docstring); the
    device is then the mesh's.  Under a mesh the stencil is the halo
    matvec (kernel ``halo_stencil`` on CUDA), for separable models only.
    """

    def __init__(
        self,
        model: Model,
        config: SolverConfig | None = None,
        device=None,
        mesh=None,
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
        self._dtype = _DTYPES[self.config.resolved_dtype(self.device)]
        self._fns: dict = {}

    @property
    def dtype(self) -> torch.dtype:
        """The vector dtype of the current (or last) solve."""
        return self._dtype

    def _set_dtype(self, name: str):
        """Re-resolve the solve dtype (the f32 tolerance contract may force
        float64 for a tight fsp_tol); invalidate per-dtype caches."""
        dt = _DTYPES[name]
        if dt is not self._dtype:
            self._dtype = dt
            self._fns = {}

    # ---------------------------------------------------------------- #

    def _device_bytes_limit(self) -> int | None:
        """The device's memory (None on the CPU, like a JAX backend that
        reports no memory_stats)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.get_device_properties(self.device).total_memory

    def _geometry_config(self, box: BoxSpace) -> SolverConfig:
        """Per-geometry config: m_max clamped so the Krylov basis
        ((m_max+2) box-volume vectors) fits config.max_basis_bytes (and
        config.max_basis_frac of the device memory when known).  Under a
        mesh the clamp still counts the whole box, as the JAX package's
        does, so that m_eff is the one-device solve's."""
        cfg = self.config
        if cfg.max_basis_bytes <= 0:
            return cfg
        budget = cfg.max_basis_bytes
        limit = self._device_bytes_limit()
        if limit:
            budget = min(budget, int(cfg.max_basis_frac * limit))
        itemsize = torch.empty((), dtype=self._dtype).element_size()
        mh = int(budget // (box.volume * itemsize))
        m_eff = min(cfg.m_max, max(cfg.m_min, mh - 2))
        if m_eff == cfg.m_max:
            return cfg
        return dataclasses.replace(cfg, m_max=m_eff)

    def _functions(self, box: BoxSpace) -> _GeometryFns:
        """Per-box-geometry step/matvec/diag/dilation masks (cached)."""
        key = (box.log2, box.axis_of_species)
        if key not in self._fns:
            mesh = self.mesh
            matvec = select_stencil_matvec(
                self.model, box, self.config, self._dtype, self.device,
                mesh=mesh,
            )
            diag = make_diag_fn(self.model, box, torch.float64, self.device,
                                None if mesh is None
                                else mesh.rows(box.volume))
            R = self.model.n_reactions

            def op_info(mask):
                nd = torch.stack([
                    torch.sum(mask).to(torch.float64),
                    torch.max(diag(mask)),
                ])
                if mesh is not None:
                    nd = torch.stack([mesh.sum(nd[0]), mesh.max(nd[1])])
                n, dmax = nd.tolist()
                # operator-norm proxy for the scaled breakdown threshold
                return int(n), R, 2.0 * dmax

            step = make_step_fn(
                lambda mask: (lambda x: matvec(mask, x)),
                self._geometry_config(box), op_info,
                reduce=None if mesh is None else mesh.sum,
            )
            self._fns[key] = _GeometryFns(
                step=step, matvec=matvec, diag=diag,
                dilate=make_dilate_fn(box, self.device, mesh),
            )
        return self._fns[key]

    def _total(self, t):
        """A float64 sum over the cell axis: over every rank under a mesh
        (``t`` a local partial), ``t`` itself on one device."""
        return t if self.mesh is None else self.mesh.sum(t)

    def _touching(self, box, mask, mesh=None) -> np.ndarray:
        touch = active_touches_face(box, mask, mesh)
        return touch & (box.extents < self.config.max_molecules + 1)

    def _grow_until_fits(self, box, mask, w):
        """Grow axes whose faces are touched by active cells (mask and w
        are re-embedded on the device).  Under a mesh a growth gathers
        mask and w to every rank, grows, and re-slices them."""
        mesh = self.mesh
        if mesh is not None:
            if not self._touching(box, mask, mesh).any():
                return box, mask, w
            mask, w = mesh.gather(mask), mesh.gather(w)
        box, mask, w = self._grow_full(box, mask, w)
        if mesh is not None:
            mask, w = mesh.local(mask), mesh.local(w)
        return box, mask, w

    def _grow_full(self, box, mask, w):
        cfg = self.config
        while True:
            touch = self._touching(box, mask)
            if not touch.any():
                return box, mask, w
            sp = int(np.argmax(touch))
            new_box = box.grow(sp)
            if new_box.volume > cfg.max_box_volume:
                raise OverflowError(
                    f"box volume {new_box.volume} exceeds max_box_volume "
                    f"{cfg.max_box_volume} (FSP overflow analog, "
                    "StateSpace.f90:389)"
                )
            mask = new_box.embed(box, mask, fill=False)
            w = new_box.embed(box, w, fill=0.0)
            box = new_box

    def _dilate(self, box, mask, rounds=1):
        dilate = self._functions(box).dilate
        for _ in range(rounds):
            mask = dilate(mask)
        return mask

    # ---------------------------------------------------------------- #

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
    ) -> BoxSolveResult:
        cfg = self.config
        verbosity = cfg.verbosity if verbosity is None else verbosity
        wall0 = time.perf_counter()
        dev = self.device

        if resume_from is not None:
            from .checkpoint import load_checkpoint

            box, mask_np, w_np, carry, t_ck, fsp_tol, krytol = (
                load_checkpoint(resume_from, self.mesh)
            )
            t = t_ck
            self._set_dtype(resolve_solve_dtype(
                cfg, float(fsp_tol), dev.type, krylov_tol=float(krytol)
            ))
            mask = torch.as_tensor(np.asarray(mask_np, bool), device=dev)
            w = torch.as_tensor(w_np, dtype=self._dtype, device=dev)
        else:
            if initial_states is None:
                raise ValueError("initial_states required unless resuming")
            self._set_dtype(resolve_solve_dtype(
                cfg, float(fsp_tol), dev.type, krylov_tol=float(krylov_tol)
            ))
            init = np.atleast_2d(np.asarray(initial_states, dtype=np.int64))
            if p0 is None:
                p0 = np.zeros(init.shape[0])
                p0[0] = 1.0
            p0 = np.asarray(p0, dtype=np.float64)

            box = BoxSpace.for_model(
                self.model.stoichiometry, init, cfg.box_min_log2
            )
            idx = box.flat_index(init).to(dev)
            mask = torch.zeros(box.volume, dtype=torch.bool, device=dev)
            w = torch.zeros(box.volume, dtype=torch.float64, device=dev)
            mask[idx] = True
            w[idx] = torch.as_tensor(p0, device=dev)
            if self.mesh is not None:
                mask, w = self.mesh.local(mask), self.mesh.local(w)

            # start-up expansion (KrylovSolver.f90:130-134)
            for _ in range(cfg.init_onestep_expansions):
                box, mask, w = self._grow_until_fits(box, mask, w)
                mask = self._dilate(box, mask)
            box, mask, w = self._grow_until_fits(box, mask, w)
            beta = float(np.linalg.norm(host_gather(w, self.mesh)))
            w = w.to(self._dtype)

            krytol = float(krylov_tol)
            if krytol <= EPS:
                krytol = float(np.sqrt(EPS))

            if beta == 0.0:
                raise ValueError("initial probability vector is zero")
            carry = initial_carry(beta, abs(t), krytol, cfg.anorm, cfg.m_min)
        ckpt_last = 0

        t_out = float(t)
        fsptol = float(fsp_tol)
        stats = SolverStats()
        hard_cap = cfg.mxstep if cfg.mxstep > 0 else 1_000_000

        iteration = 0
        fns = self._functions(box)
        while float(carry.t_now) < abs(t_out):
            iteration += 1
            if iteration > hard_cap:
                raise RuntimeError(
                    f"exceeded {hard_cap} attempted steps (IFLAG=1 analog)"
                )

            res = fns.step(mask, w, carry, t_out, fsptol, krytol)
            w, carry = res.w, res.carry
            if int(carry.iflag) == 3:
                raise RuntimeError(
                    "local Krylov error stayed NaN through the bounded "
                    "tau/5 retry (iflag=3) — basis/H numerically "
                    "corrupted (inf/NaN propensity or overscaled expm); "
                    "inspect the operator"
                )
            if int(carry.iflag) == 2:
                raise RuntimeError(
                    f"step rejected more than mxreject="
                    f"{self.config.mxreject} times (IFLAG=2, "
                    "KrylovSolver.f90:392-397); requested tolerance likely "
                    "unattainable"
                )
            dropped = 0

            # ---- drop = clear mask bits (KrylovSolver.f90:509-511) -----
            if res.advanced and res.dsum > 0.0:
                w64 = w.to(torch.float64)
                inflow = fns.matvec(mask, w).to(torch.float64)
                reduce = None if self.mesh is None else self.mesh.sum
                dmask, count, _ = drop_mask_device(
                    w64, inflow, mask, res.dsum,
                    droptol_start=cfg.droptol_start,
                    inflow_guard=cfg.inflow_guard,
                    reduce=reduce,
                )
                n_active = int(self._total(mask.sum()))
                # anti-thrash gate (same policy as the JAX fused loop's
                # drop_inline): gross-leak-rate bound with a
                # memory-pressure escape on the box volume
                loss = drop_loss_rate(w64, inflow, fns.diag(mask), dmask,
                                      reduce)
                rate_budget = cfg.drop_rate_frac * fsptol / abs(t_out)
                pressure = n_active >= cfg.drop_pressure_frac * box.volume
                if count > cfg.drop_fraction * n_active and (
                    loss <= rate_budget or pressure
                ):
                    dropped_mass = float(self._total(
                        torch.sum(torch.where(dmask, w64, 0.0))))
                    mask = mask & ~dmask
                    w = torch.where(dmask, 0.0, w)
                    dropped = count
                    stats.n_drops += 1
                    beta_new = float(torch.sqrt(
                        self._total(torch.sum(w * w))))
                    carry = carry._replace(
                        beta=np.float64(beta_new),
                        hump=np.maximum(carry.hump, beta_new),
                        spent=carry.spent + dropped_mass,
                    )

            # ---- expansion = K dilation rounds + face growth -----------
            # K event-scales with the SSA horizon (SSA_EXTENDER analog)
            if res.iexpand and float(carry.t_now) < abs(t_out):
                k = expansion_rounds(
                    self._lam_max(fns, mask, w), res.t_ssa,
                    cfg.box_expand_rounds, cfg.box_expand_rounds_max,
                )
                mask = self._dilate(box, mask, k)
                new_box, mask, w64 = self._grow_until_fits(
                    box, mask, w.to(torch.float64)
                )
                if new_box is not box:
                    box = new_box
                    fns = self._functions(box)
                    w = w64.to(self._dtype)
                    # one more dilation round inside the grown box
                    mask = self._dilate(box, mask)
                stats.n_expansions += 1

            rec = StepRecord(
                nstep=int(carry.nstep),
                fsp_size=int(self._total(mask.sum())),
                t_step=res.t_step,
                t_new=float(carry.t_new),
                t_now=float(carry.t_now),
                m=int(res.m_used),
                wsum=res.wsum,
                err_loc=res.err_loc,
                advanced=res.advanced,
                expanded=res.iexpand,
                dropped=dropped,
                wall_s=time.perf_counter() - wall0,
            )
            stats.records.append(rec)
            if verbosity:
                print(rec.format(), flush=True)
            if checkpoint_path is not None and \
                    int(carry.nstep) - ckpt_last >= checkpoint_every:
                from .checkpoint import save_checkpoint

                if self.mesh is None:
                    mask_ck = mask.cpu().numpy()
                    w_ck = w.to(torch.float64).cpu().numpy()
                else:
                    mask_ck, w_ck = mask, w
                save_checkpoint(
                    checkpoint_path, box, mask_ck, w_ck, carry, t_out,
                    fsptol, krytol, mesh=self.mesh,
                )
                ckpt_last = int(carry.nstep)

        return self._finalize(box, mask, w, carry, stats, t_out, wall0)

    def _lam_max(self, fns, mask, w) -> float:
        """Largest total propensity over mass-supported cells (the event
        rate that scales the expansion reach)."""
        support = mask & (w.to(torch.float64) > self.config.droptol_start)
        top = torch.any(support)
        if self.mesh is not None:
            top = self.mesh.any(top)
        if not bool(top):
            support = mask
        lam = torch.max(torch.where(support, fns.diag(mask), 0.0))
        return float(lam if self.mesh is None else self.mesh.max(lam))

    def m_eff(self, box: BoxSpace) -> int:
        """Krylov dimension cap of ``box`` after the basis memory clamp."""
        return self._geometry_config(box).m_max

    def _finalize(self, box, mask, w, carry, stats, t, wall0):
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

        mask_np = host_gather(mask, self.mesh)
        # report clipped probabilities (the f32 path keeps the signed
        # vector in-solve to avoid accumulating clip bias)
        w_np = np.maximum(host_gather(w.to(torch.float64), self.mesh), 0.0)
        active = np.nonzero(mask_np)[0]
        states = torch.stack(
            box.species_counts(torch.from_numpy(active), torch.int32), dim=1
        ).numpy()
        stats.final_fsp_size = int(active.size)
        stats.wall_s = time.perf_counter() - wall0
        return BoxSolveResult(
            states=states,
            probabilities=w_np[active],
            t=float(t),
            stats=stats,
            box=box,
            mask=mask_np,
            w_flat=w_np,
        )


def solve_cme_box(
    model: Model,
    t: float,
    initial_states=None,
    p0=None,
    fsp_tol: float = 1e-4,
    krylov_tol: float = 1e-10,
    config: SolverConfig | None = None,
    verbosity: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 50,
    resume_from: str | None = None,
    device=None,
    mesh=None,
) -> BoxSolveResult:
    """Solve the CME of ``model`` to time ``t`` on the masked-box backend
    (:class:`BoxCmeSolver`).  ``device`` defaults to ``"cuda"``; with
    ``mesh`` the solve is row-sharded and every rank of the mesh calls
    this with the same arguments."""
    solver = BoxCmeSolver(model, config, device=device, mesh=mesh)
    return solver.solve(
        t, initial_states, p0, fsp_tol, krylov_tol, verbosity=verbosity,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        resume_from=resume_from,
    )
