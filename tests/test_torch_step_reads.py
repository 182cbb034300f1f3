"""The stepper's device residency on the CPU: the Arnoldi extension that
reads nothing (held bit for bit against the early-exit loop it replaced,
and against the JAX package), the plain Padé expm with 0-d tensor block
size and time (against the JAX package, its clamp cases included), and the
stepper's count of host reads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu.krylov import arnoldi as jarn
from krylovfspssa_tpu.ops import expm as jexpm
from krylovfspssa_tpu_torch import SolverConfig, solve_cme_box
from krylovfspssa_tpu_torch.krylov import arnoldi as tarn
from krylovfspssa_tpu_torch.krylov import stepper as tstep
from krylovfspssa_tpu_torch.models.library import toggle_file_model
from krylovfspssa_tpu_torch.ops import expm as texpm

torch.set_num_threads(2)

N, M, MH = 40, 10, 12
BREAK_TOL = 1e-8


def _early_exit(matvec, V, H, jold, m, qiop, break_tol):
    """The extension as the port ran it before: a host read of every
    column's norm, leaving the loop at the first breakdown."""
    f = V.dtype
    nmult, brk, mb, j = 0, False, m, jold
    while j <= m:
        w = matvec(V[j - 1])
        nmult += 1
        istart = max(1, j - qiop + 1) if qiop > 0 else 1
        for i in range(istart, j + 1):
            vi = V[i - 1]
            hij = tarn.dot64(vi, w)
            w = w - hij.to(f) * vi
            H[i - 1, j - 1] = hij
        hj1j = torch.sqrt(tarn.dot64(w, w))
        if float(hj1j) <= break_tol:
            brk, mb = True, j
            break
        H[j, j - 1] = hj1j
        V[j] = w * (1.0 / hj1j).to(f)
        j += 1
    avnorm = 0.0
    if not brk:
        w = matvec(V[m])
        avnorm = float(torch.sqrt(tarn.dot64(w, w)))
        nmult += 1
    return brk, mb, avnorm, nmult


def _symmetric_case(k, seed=3):
    """A symmetric matrix (so the IOP window of 2 is Lanczos, exact on an
    invariant subspace) and a start vector in the span of k of its
    eigenvectors (k = 0: a generic vector): the extension breaks down at
    column k.  Stale values fill the basis rows after the first."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    lam = -np.linspace(1.0, 9.0, N)
    A = (Q * lam) @ Q.T
    A = 0.5 * (A + A.T)
    # eigenvectors of well-separated eigenvalues, so round-off leaves the
    # residual at column k near 1e-15
    v = rng.normal(size=N) if k == 0 else \
        Q[:, :10 * k:10] @ rng.normal(size=k)
    V0 = rng.normal(size=(MH, N))
    V0[0] = v / np.linalg.norm(v)
    return A, V0


CASES = [(0, 1), (0, 6), (1, 1), (4, 1)]


@pytest.mark.parametrize("k,jold", CASES)
def test_arnoldi_no_read_equals_early_exit(k, jold):
    """Bit for bit in float64: H, V[:mb], mb, nmult and avnorm; the rows
    of V after a breakdown are exact zeros."""
    A, V0 = _symmetric_case(k)
    At = torch.from_numpy(A)

    def mv(x):
        return At @ x

    V1, H1 = torch.from_numpy(V0.copy()), torch.zeros(MH, MH,
                                                      dtype=torch.float64)
    if jold > 1:  # the first jold-1 columns, as a grown m resumes them
        _early_exit(mv, V1, H1, 1, jold - 1, 2, BREAK_TOL)
    V2, H2 = V1.clone(), H1.clone()
    brk, mb, avnorm, nmult = _early_exit(mv, V1, H1, jold, M, 2, BREAK_TOL)
    st = tarn.arnoldi_extend(mv, V2, H2, jold, M, 2, BREAK_TOL)
    assert brk == (k > 0) and bool(st.breakdown) == brk
    assert int(st.mbrkdwn) == mb == (k if k else M)
    assert int(st.nmult) == nmult
    assert float(st.avnorm) == avnorm
    assert torch.equal(H2, H1)
    assert torch.equal(V2[:mb], V1[:mb])
    if brk:
        assert torch.all(V2[mb:M + 1] == 0)
    assert torch.all(torch.isfinite(V2))


@pytest.mark.parametrize("k,jold", CASES)
def test_arnoldi_no_read_matches_jax(k, jold):
    A, V0 = _symmetric_case(k)
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    Vt = torch.from_numpy(V0.copy())
    Ht = torch.zeros(MH, MH, dtype=torch.float64)
    Vj, Hj = jnp.asarray(V0), jnp.zeros((MH, MH))
    if jold > 1:
        pre = jarn.arnoldi_extend(lambda x: Aj @ x, Vj, Hj, jnp.asarray(1),
                                  jnp.asarray(jold - 1), 2, BREAK_TOL)
        Vj, Hj = pre.V, pre.H
        tarn.arnoldi_extend(lambda x: At @ x, Vt, Ht, 1, jold - 1, 2,
                            BREAK_TOL)
    js = jarn.arnoldi_extend(lambda x: Aj @ x, Vj, Hj, jnp.asarray(jold),
                             jnp.asarray(M), 2, BREAK_TOL)
    ts = tarn.arnoldi_extend(lambda x: At @ x, Vt, Ht, jold, M, 2,
                             BREAK_TOL)
    mb = int(js.mbrkdwn)
    assert bool(ts.breakdown) == bool(js.breakdown)
    assert int(ts.mbrkdwn) == mb
    assert int(ts.nmult) == int(js.nmult)
    assert float(ts.avnorm) == pytest.approx(float(js.avnorm), rel=1e-12)
    Hjn = np.asarray(js.H)
    np.testing.assert_allclose(ts.H.numpy(), Hjn, rtol=0,
                               atol=1e-12 * np.abs(Hjn).max())
    np.testing.assert_allclose(ts.V[:mb].numpy(), np.asarray(js.V)[:mb],
                               rtol=0, atol=1e-12)


def _refuse(*_, **__):
    raise AssertionError("host read inside arnoldi_extend")


#: every way a tensor's value reaches the host
_READS = ("__float__", "__int__", "__bool__", "__index__", "item", "tolist",
          "numpy")


@pytest.mark.parametrize("k,jold", CASES)
def test_arnoldi_extend_reads_nothing(k, jold):
    """With every host read of a tensor patched to raise, the extension
    runs to its end (and then says what the early-exit loop says)."""
    A, V0 = _symmetric_case(k)
    At = torch.from_numpy(A)

    def mv(x):
        return At @ x

    V = torch.from_numpy(V0.copy())
    H = torch.zeros(MH, MH, dtype=torch.float64)
    if jold > 1:
        tarn.arnoldi_extend(mv, V, H, 1, jold - 1, 2, BREAK_TOL)
    ref = _early_exit(mv, V.clone(), H.clone(), jold, M, 2, BREAK_TOL)
    with pytest.MonkeyPatch.context() as mp:
        for name in _READS:
            mp.setattr(torch.Tensor, name, _refuse)
        st = tarn.arnoldi_extend(mv, V, H, jold, M, 2, BREAK_TOL)
    assert (bool(st.breakdown), int(st.mbrkdwn), float(st.avnorm),
            int(st.nmult)) == ref


def _hessenberg(rng, mx, scale):
    H = rng.normal(size=(MH + 20, MH + 20))
    H[:mx, :mx] = np.triu(rng.random((mx, mx)), -1) * scale
    H[np.arange(mx), np.arange(mx)] = -scale * (1 + rng.random(mx))
    return H


@pytest.mark.parametrize("mx,t,scale,case", [
    (12, 0.7, 1.0, "plain"), (30, -2.5, 40.0, "plain"),
    (6, 300.0, 80.0, "plain"), (9, 0.4, 1.0, "hnorm 0"),
    (7, 0.5, 1.0, "hnorm inf")])
def test_expm_pade_tensor_args_match_jax(mx, t, scale, case):
    """0-d tensor mx (int64) and t (float64), as the stepper passes them,
    against the JAX expm_pade: E, hnorm and ns, to 1e-12 relative; the
    clamps (hnorm 0: ns 0 and E = I; an infinite hnorm: ns 1100 and a NaN
    block)."""
    rng = np.random.default_rng(mx)
    H = _hessenberg(rng, mx, scale)
    if case == "hnorm 0":
        H[:mx, :mx] = 0.0
    elif case == "hnorm inf":
        H[2, 3] = np.inf
    Ej, hj, nsj = jexpm.expm_pade(jnp.asarray(H), jnp.asarray(mx),
                                  jnp.asarray(t), 6)
    Et, ht, nst = texpm.expm_pade(torch.from_numpy(H),
                                  torch.tensor(mx, dtype=torch.int64),
                                  torch.tensor(t, dtype=torch.float64), 6)
    assert ht.dtype == nst.dtype == torch.float64 and ht.dim() == 0
    assert float(nst) == int(nsj)
    Ej = np.asarray(Ej)
    if case == "hnorm inf":
        assert int(nsj) == 1100 and np.isinf(float(ht))
        assert np.all(np.isnan(Et.numpy()[:mx, :mx]))
        np.testing.assert_array_equal(np.isnan(Et.numpy()), np.isnan(Ej))
        return
    assert float(ht) == pytest.approx(float(hj), rel=1e-14)
    if case == "hnorm 0":
        assert float(ht) == 0.0 and float(nst) == 0
        np.testing.assert_array_equal(Et.numpy(), np.eye(H.shape[0]))
    np.testing.assert_allclose(Et.numpy(), Ej, rtol=0,
                               atol=1e-12 * np.abs(Ej).max())


@pytest.mark.parametrize("fused", [True, False])
def test_solve_reads_per_attempt(fused):
    """A toggle t=1 box solve on the CPU: the stepper reads once per
    attempt (the Arnoldi outcome with E and hnorm), once per NaN retry and
    once per FSP evaluation -- nexph counts the first two and the FSP
    re-evaluations, so the reads are nexph plus one per attempted step."""
    tstep.READS = 0
    r = solve_cme_box(toggle_file_model(), 1.0, [[0, 0]], fsp_tol=1e-4,
                      krylov_tol=1e-8, device="cpu",
                      config=SolverConfig(fused_steps=fused))
    steps = len(r.stats.records)
    assert r.stats.iflag == 0 and steps >= 5
    assert tstep.READS == r.stats.nexph + steps
    # m columns each would read far more: at least one column per matvec
    assert tstep.READS < r.stats.nmult / 2
