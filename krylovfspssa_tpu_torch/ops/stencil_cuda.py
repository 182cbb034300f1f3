"""The Hopper stencil kernel ``box_stencil`` and its PyTorch binding.

``csrc/box_stencil.cu`` computes the separable destination-form CME
stencil SpMV (the math of ``ops/stencil.py:make_stencil_matvec``) by hand
in CUDA C++ for ``sm_90a``, in float64 and float32.  It replaces the four
TPU tilings of that function in ``krylovfspssa_tpu/ops/pallas_stencil.py``
(``make_pallas_stencil_matvec_v6``/``_v5``/``_v4``/``_v3``, ROADMAP.md
Queue B rows B1-B4).  The source header says what bounds it.

The kernel is compiled on first use with ``nvcc`` into
``build/krylovfspssa_tpu_torch/libkfs_kernels.so`` (rebuilt when the
sources change) and bound through ctypes.  The wrapper takes the plain
PyTorch version only for tensors on the CPU; for a CUDA tensor it launches
the kernel or raises.
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
from .stencil import _diag_field, _factored_reaction_tables

#: number of kernel launches made by :func:`box_stencil` (a plain counter
#: a run resets and reads to show that its matvecs went through the kernel)
LAUNCHES = 0

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "krylovfspssa_tpu_torch"
_LIB_NAME = "libkfs_kernels.so"
_lib = None


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
    """Compile ``csrc/*.cu`` for sm_90a unless the library is up to date."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in sources)).hexdigest()
    lib = _BUILD / _LIB_NAME
    stamp = _BUILD / (_LIB_NAME + ".sha1")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return BuildInfo(lib, 0.0, "")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f"{_LIB_NAME}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), *map(str, sources),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return BuildInfo(lib, secs, proc.stdout + proc.stderr)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name in ("kfs_box_stencil_f64", "kfs_box_stencil_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class StencilPack:
    """The kernel's per-geometry operands, on the solve's device."""

    #: concatenated shifted factor tables u_{k,s} of every reaction
    tables: torch.Tensor
    #: const_k per reaction
    consts: torch.Tensor
    #: int32 [off[R] | start[R+1] | (shift, ext-1, table offset) per factor]
    meta: torch.Tensor
    #: total outflow rate D per cell (built in float64, cast to dtype)
    diag: torch.Tensor
    volume: int
    n_reactions: int
    n_factors: int

    @property
    def dtype(self):
        return self.tables.dtype


def pack_stencil(model: Model, box: BoxSpace, dtype=torch.float64,
                 device="cuda") -> StencilPack:
    """Build the kernel operands for one box geometry (separable models)."""
    tables = _factored_reaction_tables(model, box)
    if tables is None:
        raise NotImplementedError(
            f"model {model.name!r} is not separable (kernel B5, ROADMAP.md "
            "Queue B, is not ported yet)"
        )
    vol = box.volume
    if vol >= 1 << 31:
        raise ValueError(f"box volume {vol} needs 64-bit indices")
    shifts = box.shift_of_species
    bits = box.bits_of_species
    starts, facs, chunks, pos = [0], [], [], 0
    for _, u_tabs, _ in tables:
        for s, tab in u_tabs.items():
            facs += [int(shifts[s]), (1 << int(bits[s])) - 1, pos]
            chunks.append(tab)
            pos += len(tab)
        starts.append(len(facs) // 3)
    meta = np.array([int(o) for o in box.offsets] + starts + facs, np.int32)
    return StencilPack(
        tables=torch.as_tensor(np.concatenate(chunks), dtype=dtype,
                               device=device),
        consts=torch.tensor([c for c, _, _ in tables], dtype=dtype,
                            device=device),
        meta=torch.as_tensor(meta, device=device),
        diag=_diag_field(tables, box, torch.float64, device).to(dtype),
        volume=vol,
        n_reactions=len(tables),
        n_factors=len(facs) // 3,
    )


def _box_stencil_plain(pack: StencilPack, mask: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, from the same operands."""
    R = pack.n_reactions
    meta = pack.meta.tolist()
    off, start, fac = meta[:R], meta[R:2 * R + 1], meta[2 * R + 1:]
    z = torch.arange(pack.volume, dtype=torch.int64, device=x.device)
    xm = torch.where(mask, x, 0)
    y = -pack.diag * xm
    for k in range(R):
        u = pack.consts[k].expand(pack.volume)
        for f in range(start[k], start[k + 1]):
            shift, emask, toff = fac[3 * f:3 * f + 3]
            u = u * pack.tables[toff + ((z >> shift) & emask)]
        y = y + u * torch.roll(xm, off[k])
    return torch.where(mask, y, 0)


def box_stencil(pack: StencilPack, mask: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """y = A x on the masked box.  CUDA tensors launch the kernel (on the
    current stream, without synchronising); CPU tensors take the plain
    version."""
    global LAUNCHES
    if x.device.type == "cpu":
        return _box_stencil_plain(pack, mask, x)
    vol = pack.volume
    if x.device.type != "cuda" or x.device != pack.tables.device:
        raise ValueError(f"x on {x.device}, operands on {pack.tables.device}")
    if mask.device != x.device:
        raise ValueError(f"mask on {mask.device}, x on {x.device}")
    if x.dtype != pack.dtype:
        raise TypeError(f"x is {x.dtype}, operands are {pack.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask is {mask.dtype}, expected torch.bool")
    if x.shape != (vol,) or mask.shape != (vol,):
        raise ValueError(
            f"x {tuple(x.shape)} / mask {tuple(mask.shape)} != ({vol},)"
        )
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError("x and mask must be contiguous")
    lib = _library()
    fn = (lib.kfs_box_stencil_f64 if x.dtype == torch.float64
          else lib.kfs_box_stencil_f32)
    y = torch.empty_like(x)
    args = (
        x.data_ptr(), mask.data_ptr(), pack.diag.data_ptr(),
        pack.tables.data_ptr(), pack.consts.data_ptr(), pack.meta.data_ptr(),
        y.data_ptr(), vol, pack.n_reactions, pack.n_factors,
        pack.tables.numel(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if x.device.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(x.device):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"box_stencil launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y


def make_box_stencil_matvec(model: Model, box: BoxSpace, dtype=torch.float64,
                            device="cuda"):
    """matvec(mask, x) through ``box_stencil`` for one box geometry."""
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"box_stencil takes float64 or float32, not {dtype}")
    pack = pack_stencil(model, box, dtype, device)

    def matvec(mask, x):
        return box_stencil(pack, mask, x)

    return matvec
