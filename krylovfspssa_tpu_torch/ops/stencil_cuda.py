"""The Hopper stencil kernels and their PyTorch bindings.

``csrc/sep_stencil.cuh`` is one kernel body, by hand in CUDA C++ for
``sm_90a`` in float64 and float32, for the destination-form CME stencil
SpMV (the math of ``ops/stencil.py:make_stencil_matvec``), in two
compile-time modes.  Three wrappers launch it:

* ``box_stencil`` (separable mode), on the whole box.  It replaces the
  four TPU tilings of that function in
  ``krylovfspssa_tpu/ops/pallas_stencil.py``
  (``make_pallas_stencil_matvec_v6``/``_v5``/``_v4``/``_v3``, ROADMAP.md
  Queue B rows B1-B4);
* ``halo_stencil`` (separable mode), on one rank's rows of a row-sharded
  box, reading the cells across the shard boundary from the two halos the
  ranks exchange (ops/halo.py).  It replaces ``make_pallas_local_matvec_v6``
  and ``make_pallas_local_matvec_v5``, Queue B rows B7 and B8;
* ``direct_stencil`` (direct mode), on the whole box or on one rank's rows
  with its two halos, for every model that ``factorize_model`` refuses
  (coupled expressions, custom propensity callables), from a stored
  diagonal and per-geometry rate fields indexed by destination with
  validity baked in.  It replaces
  ``make_pallas_stencil_matvec_v2`` and ``make_pallas_stencil_matvec``
  (v1), Queue B rows B5 and B6.

All three take the TPU kernels' contract ``supp(x) ⊆ mask``: the kernel
reads its sources without the mask.  Their plain versions mask x, and
agree with the kernel on every input that meets the contract.  The source
header says what bounds the kernel.

The kernels are compiled on first use with ``nvcc`` into
``build/krylovfspssa_tpu_torch/libkfs_kernels.so`` (rebuilt when a source or
header changes), which also holds ops/expm.py's kernel
(``csrc/expm_pade.cu``) and krylov/arnoldi.py's (``csrc/arnoldi_column.cu``),
and bound through ctypes.  Each wrapper takes its plain
PyTorch version only for tensors on the CPU; for a CUDA tensor it launches
its kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..boxspace.box import BoxSpace
from ..models.model import Model
from .stencil import (
    _cells,
    _dest_valid,
    _diag_field,
    _factored_reaction_tables,
    make_propensity_evaluator,
    to_device,
)

#: number of kernel launches made by :func:`box_stencil` (a plain counter
#: a run resets and reads to show that its matvecs went through the kernel)
LAUNCHES = 0
#: the same count for :func:`direct_stencil`
DIRECT_LAUNCHES = 0
#: the same count for :func:`halo_stencil` (per process: each rank of a
#: sharded solve counts its own launches)
HALO_LAUNCHES = 0

_CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir(package: Path) -> Path:
    """Where :func:`build` puts the library, for the package directory
    ``package``: ``build/krylovfspssa_tpu_torch/`` of a checkout (the
    directory holding ``pyproject.toml`` beside the package); for an
    installed copy, ``krylovfspssa_tpu_torch/`` under ``$XDG_CACHE_HOME``
    (default ``~/.cache``), since ``site-packages`` may not be writable."""
    root = package.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "krylovfspssa_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "krylovfspssa_tpu_torch"


_BUILD = _build_dir(_CSRC.parent)
_LIB_NAME = "libkfs_kernels.so"
_lib = None

#: log2 of the row-factor table's tile (cells), at most: species whose
#: shift is at least this are constant over a tile and folded into the table
_TILE_LOG2 = 10


class BuildInfo(NamedTuple):
    path: Path
    #: nvcc wall seconds (0 when an up-to-date library was found)
    seconds: float
    #: nvcc's messages (ptxas register / shared-memory report)
    log: str


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` (which include ``csrc/*.cuh``) for sm_90a
    unless the library is up to date with every source and header: one
    nvcc per source, all started together, then one link."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha1()
    for p in sorted(sources + list(_CSRC.glob("*.cuh"))):
        digest.update(p.name.encode() + b"\0" + p.read_bytes())
    digest = digest.hexdigest()
    lib = _BUILD / _LIB_NAME
    stamp = _BUILD / (_LIB_NAME + ".sha1")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return BuildInfo(lib, 0.0, "")
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    tag = f"{os.getpid()}.tmp"
    objs = [_BUILD / f"{src.stem}.{tag}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *arch, "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-I", str(_CSRC), "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = _BUILD / f"{_LIB_NAME}.{tag}"
    try:
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} (exit "
                                   f"{proc.returncode}):\n{log}")
        link = subprocess.run([nvcc, *arch, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):"
                               f"\n{link.stdout}{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return BuildInfo(lib, secs, "".join(logs))


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name in ("kfs_sep_stencil_f64", "kfs_sep_stencil_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
        for name in ("kfs_direct_stencil_f64", "kfs_direct_stencil_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
        # ops/expm.py: the Padé exponential
        lib.kfs_expm_pade.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.kfs_expm_pade.restype = ctypes.c_int
        lib.kfs_expm_pade_scratch.argtypes = [ctypes.c_int]
        lib.kfs_expm_pade_scratch.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _checked_volume(box: BoxSpace) -> int:
    """The box volume, which the kernels index with 32-bit ints."""
    if box.volume >= 1 << 31:
        raise ValueError(f"box volume {box.volume} needs 64-bit indices")
    return box.volume


def _check_launch_args(name, vol, operand, mask, x):
    """Raise unless x and mask are what the kernel takes: contiguous
    (vol,) tensors on the operands' CUDA device, x of the operands' dtype,
    mask bool."""
    if x.device.type != "cuda" or x.device != operand.device:
        raise ValueError(f"{name}: x on {x.device}, operands on "
                         f"{operand.device}")
    if mask.device != x.device:
        raise ValueError(f"{name}: mask on {mask.device}, x on {x.device}")
    if x.dtype != operand.dtype:
        raise TypeError(f"{name}: x is {x.dtype}, operands are "
                        f"{operand.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask is {mask.dtype}, expected torch.bool")
    if x.shape != (vol,) or mask.shape != (vol,):
        raise ValueError(
            f"{name}: x {tuple(x.shape)} / mask {tuple(mask.shape)} != "
            f"({vol},)"
        )
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{name}: x and mask must be contiguous")


def _launch(name, fn, device, args):
    """Call a kernel entry point on ``device``'s current stream; raise on a
    non-zero return (the launch was refused)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _check_dtype(name, dtype):
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"{name} takes float64 or float32, not {dtype}")


# --------------------------------------------------------------------- #
#   box_stencil / halo_stencil: separable models (kernels B1-B4, B7-B8)  #
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class StencilPack:
    """The separable kernel's operands for the rows ``[z0, z0+rows)`` of
    one box geometry (the whole box for ``box_stencil``), on the rank's
    device."""

    #: concatenated shifted factor tables u_{k,s} of every reaction
    tables: torch.Tensor
    #: const_k per reaction
    consts: torch.Tensor
    #: int32 [off[R] | start[R+1] | (shift, ext-1, table offset) per factor]
    meta: torch.Tensor
    #: each reaction's factors, (shift, ext - 1, table offset) each
    factors: tuple
    #: log2 of the row factors' tile T
    log2_tile: int
    #: the kernel's int32 meta: ``meta`` with only the factors of species
    #: whose shift is below ``log2_tile`` (looked up per cell)
    cell_meta: torch.Tensor
    #: (n_tiles, R): const_k times the factors of reaction k constant over
    #: each of the rows' tiles, validity baked in
    row_factors: torch.Tensor
    #: the rows' slice of D, the total outflow rate per cell (built in
    #: float64 from global coordinates, cast to dtype)
    diag: torch.Tensor
    volume: int
    z0: int
    rows: int
    #: H = max_k |off_k|, the length of each halo ``halo_stencil`` takes
    halo: int
    n_reactions: int

    @property
    def dtype(self):
        return self.tables.dtype

    @property
    def n_tiles(self) -> int:
        return self.row_factors.shape[0]

    def cell_factors(self, k: int) -> tuple:
        """Reaction k's factors that the kernel looks up per cell."""
        return tuple(f for f in self.factors[k] if f[0] < self.log2_tile)

    def tile_factors(self, k: int) -> tuple:
        """Reaction k's factors folded into ``row_factors``."""
        return tuple(f for f in self.factors[k] if f[0] >= self.log2_tile)


def _separable_tables(model: Model, box: BoxSpace):
    tables = _factored_reaction_tables(model, box)
    if tables is None:
        raise ValueError(
            f"model {model.name!r} is not separable; its operands are "
            "pack_direct_stencil's (kernel direct_stencil)"
        )
    return tables


def _meta(offsets, facs, device) -> torch.Tensor:
    """int32 [off[R] | start[R+1] | (shift, ext-1, table offset) per
    factor] of the factor lists ``facs``."""
    starts = np.cumsum([0] + [len(fk) for fk in facs]).tolist()
    return to_device(np.array(
        list(offsets) + starts + [v for fk in facs for f in fk for v in f],
        np.int32), torch.int32, device)


def _factor_operands(tables, box: BoxSpace, dtype, device):
    """The shifted factor tables, consts and int32 meta of the separable
    kernel, and each reaction's (shift, ext - 1, table offset) list."""
    shifts = box.shift_of_species
    bits = box.bits_of_species
    facs, chunks, pos = [], [], 0
    for _, u_tabs, _ in tables:
        fk = []
        for s, tab in u_tabs.items():
            fk.append((int(shifts[s]), (1 << int(bits[s])) - 1, pos))
            chunks.append(tab)
            pos += len(tab)
        facs.append(tuple(fk))
    return dict(
        tables=to_device(np.concatenate(chunks), dtype, device),
        consts=to_device([c for c, _, _ in tables], dtype, device),
        meta=_meta([int(o) for o in box.offsets], facs, device),
        n_reactions=len(tables),
    ), tuple(facs)


def _factor_products(facs, tables, u, z):
    """u * prod_s u_{k,s}[c_s(z)] over the (shift, ext - 1, table offset)
    list ``facs``, in the list's order."""
    for shift, emask, toff in facs:
        u = u * tables[toff + ((z >> shift) & emask)]
    return u


def _row_factors(facs, log2t: int, tables, consts, z0: int,
                 rows: int) -> torch.Tensor:
    """(n_tiles, R) table F of the tiles that meet ``[z0, z0+rows)``:
    const_k times reaction k's factors of the species whose coordinate is
    constant over a tile, at the tile's first cell."""
    g0 = z0 >> log2t
    n = ((z0 + rows - 1) >> log2t) - g0 + 1
    zt = torch.arange(g0, g0 + n, dtype=torch.int64,
                      device=tables.device) << log2t
    return torch.stack([
        _factor_products(tuple(f for f in fk if f[0] >= log2t), tables,
                         consts[k].expand(n), zt)
        for k, fk in enumerate(facs)
    ], dim=1).contiguous()


def pack_halo_stencil(model: Model, box: BoxSpace, dtype=torch.float64,
                      device="cuda", z0: int = 0,
                      rows: int | None = None) -> StencilPack:
    """Build the separable kernel's operands for the rows
    ``[z0, z0+rows)`` of one box geometry (separable models; the whole box
    by default).  Every shard of a box shares its tiles: they sit at global
    multiples of T."""
    from .halo import halo_width

    tables = _separable_tables(model, box)
    vol = _checked_volume(box)
    rows = vol - z0 if rows is None else rows
    if not (0 <= z0 and rows > 0 and z0 + rows <= vol):
        raise ValueError(f"rows [{z0}, {z0 + rows}) outside a box of "
                         f"{vol} cells")
    ops, facs = _factor_operands(tables, box, dtype, device)
    log2t = min(_TILE_LOG2, vol.bit_length() - 1)
    return StencilPack(
        **ops,
        factors=facs,
        log2_tile=log2t,
        cell_meta=_meta([int(o) for o in box.offsets],
                        [tuple(f for f in fk if f[0] < log2t) for fk in facs],
                        device),
        row_factors=_row_factors(facs, log2t, ops["tables"], ops["consts"],
                                 z0, rows),
        diag=_diag_field(tables, box, torch.float64, device,
                         rows=(z0, rows)).to(dtype),
        volume=vol, z0=z0, rows=rows, halo=halo_width(box),
    )


def pack_stencil(model: Model, box: BoxSpace, dtype=torch.float64,
                 device="cuda") -> StencilPack:
    """Build ``box_stencil``'s operands for one box geometry (separable
    models): :func:`pack_halo_stencil` on the whole box."""
    return pack_halo_stencil(model, box, dtype, device)


def _propensity(pack: StencilPack, k: int, z: torch.Tensor) -> torch.Tensor:
    """const_k * prod_s u_{k,s}[c_s(z)] over every factor of reaction k, at
    the global cells z: the plain version's rate, cell by cell."""
    return _factor_products(pack.factors[k], pack.tables,
                            pack.consts[k].expand(z.shape), z)


def _rate(pack: StencilPack, k: int, z: torch.Tensor) -> torch.Tensor:
    """u_k(z) = F[tile(z), k] * prod of reaction k's per-cell factors, at
    the global cells z of the pack's rows: the kernel's rate, in its
    order."""
    t = (z >> pack.log2_tile) - (pack.z0 >> pack.log2_tile)
    return _factor_products(pack.cell_factors(k), pack.tables,
                            pack.row_factors[t, k], z)


def _halo_stencil_plain(pack: StencilPack, mask: torch.Tensor,
                        x: torch.Tensor, left: torch.Tensor,
                        right: torch.Tensor) -> torch.Tensor:
    """The stencil in plain PyTorch: every factor of every reaction per
    cell (no tile table), sources from ``[left | mask*x | right]``.  It
    masks x, so it holds without the kernel's contract."""
    H, n = pack.halo, pack.rows
    z = torch.arange(pack.z0, pack.z0 + n, dtype=torch.int64,
                     device=x.device)
    xm = torch.where(mask, x, 0)
    xpad = torch.cat([left, xm, right])
    y = -pack.diag * xm
    for k, off in enumerate(pack.meta[:pack.n_reactions].tolist()):
        # source of local cell i is local cell i - off_k: padded index
        # H + i - off_k
        src = H - off
        y = y + _propensity(pack, k, z) * xpad[src:src + n]
    return torch.where(mask, y, 0)


def _box_stencil_plain(pack: StencilPack, mask: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """:func:`_halo_stencil_plain` on the whole box with zero halos (the
    shifted tables are zero wherever the source leaves the box)."""
    zeros = x.new_zeros(pack.halo)
    return _halo_stencil_plain(pack, mask, x, zeros, zeros)


def _launch_separable(name, pack: StencilPack, mask, x, left, right, hl):
    lib = _library()
    fn = (lib.kfs_sep_stencil_f64 if x.dtype == torch.float64
          else lib.kfs_sep_stencil_f32)
    y = torch.empty_like(x)
    _launch(name, fn, x.device, (
        x.data_ptr(), mask.data_ptr(), left, right, pack.diag.data_ptr(),
        pack.tables.data_ptr(), pack.row_factors.data_ptr(),
        pack.cell_meta.data_ptr(), y.data_ptr(), pack.rows, pack.z0, hl,
        pack.n_reactions, pack.cell_meta.numel(), pack.tables.numel(),
        pack.log2_tile,
    ))
    return y


def box_stencil(pack: StencilPack, mask: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """y = A x on the masked box.  The kernel takes ``supp(x) ⊆ mask``
    (the solver keeps it; pass ``torch.where(mask, x, 0)`` otherwise).
    CUDA tensors launch the kernel (on the current stream, without
    synchronising); CPU tensors take the plain version."""
    global LAUNCHES
    if x.device.type == "cpu":
        return _box_stencil_plain(pack, mask, x)
    if pack.rows != pack.volume:
        raise ValueError("box_stencil: the operands hold rows "
                         f"[{pack.z0}, {pack.z0 + pack.rows}) of the box; "
                         "use halo_stencil")
    _check_launch_args("box_stencil", pack.volume, pack.tables, mask, x)
    y = _launch_separable("box_stencil", pack, mask, x, None, None, 0)
    LAUNCHES += 1
    return y


def halo_stencil(pack: StencilPack, mask: torch.Tensor, x: torch.Tensor,
                 left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """y = A x on one rank's rows.  ``x`` and ``mask`` are the rows,
    ``left``/``right`` the masked x at the H cells before and after them
    (zero outside the box).  The kernel takes ``supp(x) ⊆ mask``, as
    :func:`box_stencil`.  CUDA tensors launch the kernel (on the current
    stream, without synchronising); CPU tensors take the plain version."""
    global HALO_LAUNCHES
    for name, h in (("left", left), ("right", right)):
        if h.shape != (pack.halo,) or h.dtype != x.dtype or \
                h.device != x.device:
            raise ValueError(
                f"halo_stencil: {name} halo {tuple(h.shape)} {h.dtype} on "
                f"{h.device}, expected ({pack.halo},) {x.dtype} on "
                f"{x.device}")
    if x.device.type == "cpu":
        return _halo_stencil_plain(pack, mask, x, left, right)
    _check_launch_args("halo_stencil", pack.rows, pack.tables, mask, x)
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("halo_stencil: halos must be contiguous")
    y = _launch_separable("halo_stencil", pack, mask, x, left.data_ptr(),
                          right.data_ptr(), pack.halo)
    HALO_LAUNCHES += 1
    return y


def make_box_stencil_matvec(model: Model, box: BoxSpace, dtype=torch.float64,
                            device="cuda"):
    """matvec(mask, x) through ``box_stencil`` for one box geometry."""
    _check_dtype("box_stencil", dtype)
    pack = pack_stencil(model, box, dtype, device)

    def matvec(mask, x):
        return box_stencil(pack, mask, x)

    return matvec


# --------------------------------------------------------------------- #
#            direct_stencil: any propensity (kernels B5 / B6)           #
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class DirectPack:
    """``direct_stencil``'s per-geometry operands for the rows
    ``[z0, z0+rows)`` of one box geometry (the whole box by default), on
    the rank's device: (R + 1) * rows * itemsize bytes of device memory."""

    #: D = sum_k a_k, the total outflow rate per cell of the rows, summed
    #: in k order from the propensity fields cast to dtype
    diag: torch.Tensor
    #: (R, rows): U_k[z] = valid_k(z) ? a_k(z - nu_k) : 0, each reaction's
    #: rate at its destination z = z0 + i, zero where the source leaves
    #: the box
    rates: torch.Tensor
    #: int32 off[R], the flat offset of each reaction
    meta: torch.Tensor
    volume: int
    n_reactions: int
    z0: int = 0
    #: number of cells of the rows (``volume`` for the whole box)
    rows: int | None = None
    #: H = max_k |off_k|, the length of each halo a row shard takes
    halo: int = 0

    def __post_init__(self):
        if self.rows is None:
            object.__setattr__(self, "rows", self.volume)

    @property
    def dtype(self):
        return self.rates.dtype


#: cells whose propensities are evaluated at a time when building
#: ``direct_stencil``'s operands: bounds the evaluator's temporaries (a
#: callable's (n, d) state stack and its intermediates) to a few fields'
#: worth, whatever the box
_FIELD_CHUNK = 1 << 21


def _field_window(evaluate, box: BoxSpace, k: int, lo: int, hi: int,
                  out: torch.Tensor) -> None:
    """Write a_k at the cells ``[lo, hi)`` into ``out`` (cast to its dtype).
    The field is evaluated over the whole box's ``_FIELD_CHUNK`` grid, a
    chunk at a time, and each chunk is evaluated whole: a cell's value is
    then the bits the whole-box build gives it, whatever the window (an
    elementwise op can round the tail of its input apart from the rest)."""
    vol = box.volume
    for c0 in range(lo - lo % _FIELD_CHUNK, hi, _FIELD_CHUNK):
        n = min(_FIELD_CHUNK, vol - c0)
        a, b = max(lo, c0), min(hi, c0 + n)
        if a >= b:
            continue
        f = evaluate(_cells(box, out.device, (c0, n)), k)
        out[a - lo:b - lo] = f[a - c0:b - c0]


def pack_direct_stencil(model: Model, box: BoxSpace, dtype=torch.float64,
                        device="cuda", z0: int = 0,
                        rows: int | None = None) -> DirectPack:
    """Build ``direct_stencil``'s operands for the rows ``[z0, z0+rows)``
    of one box geometry (any model: the fields come from its expressions
    or its callable; the whole box by default).  A rank's rate at z reads
    the field at z - nu_k, which may lie on a neighbour's rows, so each
    propensity field a_k is evaluated in float64 at the global cells
    ``[z0-H, z0+rows+H)`` (``_FIELD_CHUNK`` cells at a time), cast to
    dtype, added to D and shifted into U_k before the next one is built:
    the build holds one window of a field beside the pack, and a shard's
    pack is the bits of the same rows of the whole box's."""
    from .halo import halo_width

    vol = _checked_volume(box)
    rows = vol - z0 if rows is None else rows
    if not (0 <= z0 and rows > 0 and z0 + rows <= vol):
        raise ValueError(f"rows [{z0}, {z0 + rows}) outside a box of "
                         f"{vol} cells")
    offsets = [int(o) for o in box.offsets]
    H = halo_width(box)
    evaluate = make_propensity_evaluator(model, box, torch.float64, device)
    lo, hi = max(z0 - H, 0), min(z0 + rows + H, vol)
    diag = torch.zeros(rows, dtype=dtype, device=device)
    rates = torch.zeros((len(offsets), rows), dtype=dtype, device=device)
    field = torch.empty(hi - lo, dtype=dtype, device=device)
    local = [(c0, min(_FIELD_CHUNK, rows - c0))
             for c0 in range(0, rows, _FIELD_CHUNK)]
    for k, off in enumerate(offsets):
        _field_window(evaluate, box, k, lo, hi, field)
        diag += field[z0 - lo:z0 - lo + rows]
        # U_k[z0 + i] = a_k(z0 + i - off) where that cell is in the box
        i0 = min(max(lo + off - z0, 0), rows)
        i1 = max(min(hi + off - z0, rows), i0)
        rates[k, i0:i1] = field[z0 + i0 - off - lo:z0 + i1 - off - lo]
        for c0, n in local:
            valid = _dest_valid(box, _cells(box, device, (z0 + c0, n)), k)
            rates[k, c0:c0 + n].masked_fill_(~valid, 0)
    return DirectPack(
        diag=diag, rates=rates,
        meta=torch.tensor(offsets, dtype=torch.int32, device=device),
        volume=vol, n_reactions=len(offsets), z0=z0, rows=rows, halo=H,
    )


def _direct_stencil_plain(pack: DirectPack, mask: torch.Tensor,
                          x: torch.Tensor, left=None,
                          right=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, from the same operands:
    y = mask * (-D * xm + sum_k U_k * src_k), src_k = roll(xm, off_k) on
    the whole box, or xm shifted by off_k with the halos
    ``[left | xm | right]`` on a row shard.  It masks x, so it holds
    without the kernel's contract."""
    xm = torch.where(mask, x, 0)
    y = -pack.diag * xm
    offsets = pack.meta.tolist()
    if left is None:
        for k, off in enumerate(offsets):
            y = y + pack.rates[k] * torch.roll(xm, off)
    else:
        H, n = pack.halo, pack.rows
        xpad = torch.cat([left, xm, right])
        for k, off in enumerate(offsets):
            # source of local cell i is local cell i - off_k: padded index
            # H + i - off_k
            y = y + pack.rates[k] * xpad[H - off:H - off + n]
    return torch.where(mask, y, 0)


def direct_stencil(pack: DirectPack, mask: torch.Tensor, x: torch.Tensor,
                   left: torch.Tensor | None = None,
                   right: torch.Tensor | None = None) -> torch.Tensor:
    """y = A x for any propensity: on the masked box, or with ``left`` and
    ``right`` (the masked x at the H cells before and after the rows,
    zero outside the box) on the rows of a row-shard pack.  The kernel
    takes ``supp(x) ⊆ mask``, as :func:`box_stencil`.  CUDA tensors launch
    the kernel (on the current stream, without synchronising); CPU tensors
    take the plain version."""
    global DIRECT_LAUNCHES
    if (left is None) != (right is None):
        raise ValueError("direct_stencil: pass both halos or neither")
    if left is None and pack.rows != pack.volume:
        raise ValueError("direct_stencil: the operands hold rows "
                         f"[{pack.z0}, {pack.z0 + pack.rows}) of the box; "
                         "pass their halos")
    for name, h in (("left", left), ("right", right)):
        if h is not None and (h.shape != (pack.halo,) or h.dtype != x.dtype
                              or h.device != x.device):
            raise ValueError(
                f"direct_stencil: {name} halo {tuple(h.shape)} {h.dtype} on "
                f"{h.device}, expected ({pack.halo},) {x.dtype} on "
                f"{x.device}")
    if x.device.type == "cpu":
        return _direct_stencil_plain(pack, mask, x, left, right)
    _check_launch_args("direct_stencil", pack.rows, pack.rates, mask, x)
    halos = (None, None, 0)
    if left is not None:
        if not (left.is_contiguous() and right.is_contiguous()):
            raise ValueError("direct_stencil: halos must be contiguous")
        halos = (left.data_ptr(), right.data_ptr(), pack.halo)
    lib = _library()
    fn = (lib.kfs_direct_stencil_f64 if x.dtype == torch.float64
          else lib.kfs_direct_stencil_f32)
    y = torch.empty_like(x)
    _launch("direct_stencil", fn, x.device, (
        x.data_ptr(), mask.data_ptr(), halos[0], halos[1],
        pack.diag.data_ptr(), pack.rates.data_ptr(), pack.meta.data_ptr(),
        y.data_ptr(), pack.rows, pack.z0, halos[2], pack.n_reactions,
    ))
    DIRECT_LAUNCHES += 1
    return y


def make_direct_stencil_matvec(model: Model, box: BoxSpace,
                               dtype=torch.float64, device="cuda"):
    """matvec(mask, x) through ``direct_stencil`` for one box geometry."""
    _check_dtype("direct_stencil", dtype)
    pack = pack_direct_stencil(model, box, dtype, device)

    def matvec(mask, x):
        return direct_stencil(pack, mask, x)

    return matvec
