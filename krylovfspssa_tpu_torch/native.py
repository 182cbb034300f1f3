"""The native host hash of the table backend, bound through ctypes
(PyTorch port of ``krylovfspssa_tpu/native/__init__.py``).

``csrc/kfs_hash.cpp`` is an open-addressing int64 key -> int32 row hash
(the reference's HashTable.f90 parity surface, batch APIs).  It is built
with ``g++ -O3 -shared -fPIC -std=c++17`` on first use into the directory
that holds the CUDA kernels' library (``ops/stencil_cuda.py``:
``build/krylovfspssa_tpu_torch/`` of a checkout, ``krylovfspssa_tpu_torch/``
under ``$XDG_CACHE_HOME`` for an installed copy), and rebuilt when the
source, the compiler or the machine changes (a checkout copied to another
host rebuilds its library there).  Unlike the JAX package's loader, a
failed build raises: nothing falls back to the numpy path quietly
(statespace/table.py takes that path only when asked for by name).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from .ops.stencil_cuda import _BUILD

_SRC = Path(__file__).resolve().parent / "csrc" / "kfs_hash.cpp"
_LIB_NAME = "libkfs_hash.so"
_lib = None


class BuildInfo(NamedTuple):
    path: Path
    #: g++ wall seconds (0 when an up-to-date library was found)
    seconds: float


def _stamp() -> str:
    """What a library must have been built from to count as up to date:
    the source's SHA-1, g++'s version, the machine and its C library."""
    try:
        proc = subprocess.run(["g++", "-dumpfullversion"],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {_SRC.name}: {e}") from e
    return "\n".join([
        hashlib.sha1(_SRC.read_bytes()).hexdigest(),
        "g++ " + proc.stdout.strip(),
        platform.machine(),
        " ".join(platform.libc_ver()),
    ]) + "\n"


def build() -> BuildInfo:
    """Compile ``csrc/kfs_hash.cpp`` unless the library is up to date with
    it (``_stamp``); raise ``RuntimeError`` with g++'s messages if the
    build fails."""
    digest = _stamp()
    lib = _BUILD / _LIB_NAME
    stamp = _BUILD / (_LIB_NAME + ".stamp")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return BuildInfo(lib, 0.0)
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f"{_LIB_NAME}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
           "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {_SRC.name}: {e}") from e
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed on {_SRC.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return BuildInfo(lib, secs)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        lib.kfs_hash_create.restype = ctypes.c_void_p
        lib.kfs_hash_create.argtypes = [ctypes.c_int64]
        lib.kfs_hash_destroy.argtypes = [ctypes.c_void_p]
        lib.kfs_hash_size.restype = ctypes.c_int64
        lib.kfs_hash_size.argtypes = [ctypes.c_void_p]
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.kfs_hash_insert_batch.argtypes = [
            ctypes.c_void_p, p_i64, p_i32, ctypes.c_int64, p_i32,
        ]
        lib.kfs_hash_lookup_batch.argtypes = [
            ctypes.c_void_p, p_i64, ctypes.c_int64, p_i32,
        ]
        lib.kfs_hash_delete_batch.argtypes = [
            ctypes.c_void_p, p_i64, ctypes.c_int64, p_i32,
        ]
        lib.kfs_hash_assign_fresh.restype = ctypes.c_int64
        lib.kfs_hash_assign_fresh.argtypes = [
            ctypes.c_void_p, p_i64, ctypes.c_int64, ctypes.c_int32, p_i32,
        ]
        _lib = lib
    return _lib


class NativeHashTable:
    """int64 key -> int32 row index open-addressing hash (C++ backed).
    Negative keys are invalid: never stored, looked up as -1."""

    def __init__(self, expected: int = 1024):
        self._lib = _library()
        self._h = self._lib.kfs_hash_create(int(expected))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.kfs_hash_destroy(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.kfs_hash_size(self._h))

    def insert(self, keys, values) -> np.ndarray:
        """Insert keys[i] -> values[i]; returns the value now held by each
        key (the earlier one for a key already present), -1 if invalid."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        values = np.ascontiguousarray(values, dtype=np.int32)
        out = np.empty(keys.shape[0], dtype=np.int32)
        self._lib.kfs_hash_insert_batch(
            self._h, keys, values, keys.shape[0], out
        )
        return out

    def lookup(self, keys) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.empty(keys.shape[0], dtype=np.int32)
        self._lib.kfs_hash_lookup_batch(self._h, keys, keys.shape[0], out)
        return out

    def delete(self, keys) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.empty(keys.shape[0], dtype=np.int32)
        self._lib.kfs_hash_delete_batch(self._h, keys, keys.shape[0], out)
        return out.astype(bool)

    def assign_fresh(self, keys, next_row: int) -> tuple[np.ndarray, int]:
        """Rows for a candidate batch: consecutive rows from ``next_row``
        to keys absent before (first occurrence wins), -1 for invalid,
        duplicate and present keys; and the number of fresh keys."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.empty(keys.shape[0], dtype=np.int32)
        fresh = self._lib.kfs_hash_assign_fresh(
            self._h, keys, keys.shape[0], int(next_row), out
        )
        return out, int(fresh)
