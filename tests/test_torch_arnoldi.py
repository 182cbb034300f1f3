"""The Arnoldi column's plain version on the CPU: the wrapper
(krylov/arnoldi.py ``column_update``, ``avnorm_update``) runs it for CPU
tensors and launches nothing; the extension matches a modified
Gram-Schmidt written here in numpy, breakdowns included; and the package
imports and runs a column with no ``nvcc`` on the path.  The kernel
(csrc/arnoldi_column.cu) is held against the plain version on the card in
tests/test_torch_arnoldi_cuda.py."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from krylovfspssa_tpu_torch.krylov import arnoldi

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
N, M, MH, TOL = 40, 10, 12, 1e-8


def _column_inputs(dtype, j, broken, seed=0):
    """A basis with j valid rows and stale rows after them, a garbage H, a
    status (live, or broken at column 2) and a w."""
    rng = np.random.default_rng(seed)
    V = torch.as_tensor(rng.normal(size=(MH, N)), dtype=dtype)
    H = torch.as_tensor(rng.normal(size=(MH, MH)))
    status = torch.tensor([1.0, 2.0, 0.0] if broken else [0.0, M, 0.0],
                          dtype=torch.float64)
    w = torch.as_tensor(rng.normal(size=N), dtype=dtype)
    return w, V, H, status


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("qiop,j", [(2, 1), (2, 5), (1, 5), (0, 5)])
@pytest.mark.parametrize("broken", [False, True])
def test_wrapper_on_the_cpu_runs_the_plain_column(dtype, qiop, j, broken):
    """On CPU tensors ``column_update`` and ``avnorm_update`` are their
    plain versions, bit for bit, and launch no kernel."""
    before = arnoldi.LAUNCHES
    w, V, H, status = _column_inputs(dtype, j, broken)
    Vp, Hp, sp = V.clone(), H.clone(), status.clone()
    arnoldi.column_update(w, V, H, status, j, qiop, TOL)
    arnoldi.column_update_plain(w, Vp, Hp, sp, j, qiop, TOL)
    arnoldi.avnorm_update(w, V, status)
    arnoldi.avnorm_update_plain(w, sp)
    assert torch.equal(V, Vp) and torch.equal(H, Hp)
    assert torch.equal(status, sp)
    assert arnoldi.LAUNCHES == before


def _mgs_numpy(A, V, H, m, qiop, tol):
    """Columns 1..m of the IOP Arnoldi process by modified Gram-Schmidt in
    numpy, with the extension's breakdown contract: at the first norm <=
    tol the column's h are kept, H[j, j-1] is not written and V[j] and
    every later row are zeros; later columns leave H alone.  Returns V, H,
    the breakdown flag, mb and avnorm."""
    V, H = V.copy(), H.copy()
    brk, mb = False, m
    for j in range(1, m + 1):
        if brk:
            V[j] = 0.0
            continue
        w = A @ V[j - 1]
        istart = max(1, j - qiop + 1) if qiop > 0 else 1
        for i in range(istart, j + 1):
            H[i - 1, j - 1] = V[i - 1] @ w
            w = w - H[i - 1, j - 1] * V[i - 1]
        hn = np.sqrt(w @ w)
        if hn <= tol:
            brk, mb = True, j
            V[j] = 0.0
            continue
        H[j, j - 1] = hn
        V[j] = w * (1.0 / hn)
    avnorm = 0.0 if brk else float(np.linalg.norm(A @ V[m]))
    return V, H, brk, mb, avnorm


def _symmetric(k, seed=3):
    """A symmetric negative definite matrix and a start vector in the span
    of k of its eigenvectors of well-separated eigenvalues (k = 0: a
    generic vector), so a window that holds the invariant subspace breaks
    down at column k."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    lam = -np.linspace(1.0, 9.0, N)
    A = (Q * lam) @ Q.T
    A = 0.5 * (A + A.T)
    v = rng.normal(size=N) if k == 0 else Q[:, :10 * k:10] @ rng.normal(
        size=k)
    return A, v / np.linalg.norm(v)


@pytest.mark.parametrize("qiop,k", [(1, 0), (2, 0), (0, 0), (1, 1), (2, 1),
                                    (0, 1), (2, 3), (0, 3)])
def test_extend_on_the_cpu_matches_numpy_mgs(qiop, k):
    """``arnoldi_extend`` on the CPU against the numpy MGS: H and V to
    1e-12 of their largest entry, the breakdown, its column, avnorm and
    nmult.  k = 1 (an eigenvector) breaks down at column 1 under every
    window; k = 3 under the Lanczos window and the full one."""
    before = arnoldi.LAUNCHES
    A, v = _symmetric(k)
    rng = np.random.default_rng(11)
    V0 = rng.normal(size=(MH, N))  # stale rows after the first
    V0[0] = v
    H0 = rng.normal(size=(MH, MH))
    Vr, Hr, brk, mb, avnorm = _mgs_numpy(A, V0, H0, M, qiop, TOL)
    At = torch.as_tensor(A)
    V, H = torch.as_tensor(V0.copy()), torch.as_tensor(H0.copy())
    st = arnoldi.arnoldi_extend(lambda x: At @ x, V, H, 1, M, qiop, TOL)
    assert bool(st.breakdown) == brk == (k > 0)
    assert int(st.mbrkdwn) == mb == (k if k else M)
    assert int(st.nmult) == mb + 1 - int(brk)
    np.testing.assert_allclose(V.numpy(), Vr, rtol=0,
                               atol=1e-12 * np.abs(Vr).max())
    np.testing.assert_allclose(H.numpy(), Hr, rtol=0,
                               atol=1e-12 * np.abs(Hr).max())
    assert float(st.avnorm) == pytest.approx(avnorm, rel=1e-12, abs=0.0)
    assert arnoldi.LAUNCHES == before


_NO_NVCC = r"""
import importlib, pkgutil, shutil
import torch
torch.set_num_threads(2)
assert shutil.which("nvcc") is None
import krylovfspssa_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from krylovfspssa_tpu_torch.krylov import arnoldi
from krylovfspssa_tpu_torch.ops import stencil_cuda
A = -torch.diag(torch.arange(1.0, 7.0, dtype=torch.float64))
V = torch.zeros(5, 6, dtype=torch.float64)
V[0] = 6 ** -0.5
H = torch.zeros(5, 5, dtype=torch.float64)
st = arnoldi.arnoldi_extend(lambda x: A @ x, V, H, 1, 3, 2, 1e-8)
assert not bool(st.breakdown) and float(H[1, 0]) > 0
assert arnoldi.LAUNCHES == 0 and stencil_cuda._lib is None
print("ok")
"""


def test_the_package_imports_and_runs_a_column_without_nvcc():
    """Nothing builds or loads the kernels' library while the package is
    imported or a CPU column runs: a fresh interpreter whose PATH holds no
    ``nvcc`` (and no CUDA_HOME) imports every module and extends a basis."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and shutil.which("nvcc", path=d) is None)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _NO_NVCC], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
