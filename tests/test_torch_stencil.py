"""PyTorch port vs JAX package: the stencil matvec (plain destination form,
direct-eval form, and the packed operands of the CUDA kernel), the
diagonal, mask dilation, expansion rounds, face detection, and the
selector.  The kernel itself is compared with its plain version on the
card in tests/test_torch_stencil_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu.boxspace.box import BoxSpace as JBox
from krylovfspssa_tpu.config import SolverConfig as JConfig
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu.models.model import Model as JModel
from krylovfspssa_tpu.ops import stencil as jst
from krylovfspssa_tpu.ops.pallas_stencil import make_pallas_stencil_matvec_v6
from krylovfspssa_tpu_torch.boxspace.box import BoxSpace as TBox
from krylovfspssa_tpu_torch.config import SolverConfig
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.models.model import Model as TModel
from krylovfspssa_tpu_torch.ops import stencil as tst
from krylovfspssa_tpu_torch.ops import stencil_cuda

torch.set_num_threads(2)

# (model, x0, per-species extents): small boxes of each bundled shape
GEOMETRIES = [
    ("toggle", [[0, 0]], [64, 32]),
    ("goutsias", [[2, 6, 0, 2, 0, 0]], [16, 16, 8, 4, 4, 4]),
    ("repressilator", [[0, 0, 0]], [8, 16, 8]),
    ("bursting_gene", [[0, 0]], [4, 64]),
]


def _grown(box_cls, stoich, x0, targets):
    box = box_cls.for_model(stoich, x0)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    return box


def _setup(name, x0, targets, seed=0):
    jm, tm = jlib.get_model(name), tlib.get_model(name)
    jb = _grown(JBox, jm.stoichiometry, x0, targets)
    tb = _grown(TBox, tm.stoichiometry, x0, targets)
    rng = np.random.default_rng(seed)
    mask = rng.random(jb.volume) < 0.6
    x = rng.random(jb.volume)
    return jm, tm, jb, tb, mask, x


def _close(got, ref, rtol):
    """max |got - ref| <= rtol * max |ref| (relative to the output scale)."""
    scale = float(np.max(np.abs(ref)))
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(ref))))
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("name,x0,targets", GEOMETRIES)
def test_destination_form_matches_jax_f64(name, x0, targets):
    jm, tm, jb, tb, mask, x = _setup(name, x0, targets)
    ref = np.asarray(jst.make_stencil_matvec(jm, jb, jnp.float64)(
        jnp.asarray(mask), jnp.asarray(x)))
    got = tst.make_stencil_matvec(tm, tb, torch.float64, "cpu")(
        torch.from_numpy(mask), torch.from_numpy(x))
    _close(got.numpy(), ref, 1e-12)


@pytest.mark.parametrize("name,x0,targets", GEOMETRIES)
def test_kernel_operands_plain_matches_jax_f64(name, x0, targets):
    """box_stencil on CPU tensors: the kernel's own arithmetic over its
    packed operands (tables, factor lists, offsets) in plain PyTorch."""
    jm, tm, jb, tb, mask, x = _setup(name, x0, targets)
    ref = np.asarray(jst.make_stencil_matvec(jm, jb, jnp.float64)(
        jnp.asarray(mask), jnp.asarray(x)))
    before = stencil_cuda.LAUNCHES
    pack = stencil_cuda.pack_stencil(tm, tb, torch.float64, "cpu")
    got = stencil_cuda.box_stencil(
        pack, torch.from_numpy(mask), torch.from_numpy(x))
    _close(got.numpy(), ref, 1e-12)
    assert stencil_cuda.LAUNCHES == before  # no kernel on a CPU tensor


def _nonseparable(model_cls):
    return model_cls(
        n_species=2, n_reactions=4, n_parameters=2,
        stoichiometry=np.array([[1, 0], [-1, 0], [0, 1], [0, -1]]),
        species_names=["X", "Y"], parameter_names=["k", "d"],
        propensity_expressions=["k/(1 + X + Y)", "d*X", "k*(X+Y)/(10+Y)",
                                "d*Y"],
        parameters=[20.0, 1.0], name="nonsep",
    )


def test_direct_eval_form_matches_jax_f64():
    jm, tm = _nonseparable(JModel), _nonseparable(TModel)
    jb = _grown(JBox, jm.stoichiometry, [[0, 0]], [32, 16])
    tb = _grown(TBox, tm.stoichiometry, [[0, 0]], [32, 16])
    rng = np.random.default_rng(2)
    mask, x = rng.random(jb.volume) < 0.7, rng.random(jb.volume)
    ref = np.asarray(jst.make_stencil_matvec(jm, jb, jnp.float64)(
        jnp.asarray(mask), jnp.asarray(x)))
    got = tst.make_stencil_matvec(tm, tb, torch.float64, "cpu")(
        torch.from_numpy(mask), torch.from_numpy(x))
    _close(got.numpy(), ref, 1e-12)
    np.testing.assert_allclose(
        tst.make_diag_fn(tm, tb)(torch.from_numpy(mask)).numpy(),
        np.asarray(jst.make_diag_fn(jm, jb)(jnp.asarray(mask))),
        rtol=1e-15, atol=0,
    )
    # on a GPU this model needs kernel B5, which is not ported yet
    with pytest.raises(NotImplementedError, match="B5"):
        tst.select_stencil_matvec(tm, tb, SolverConfig(), torch.float64,
                                  "cuda")


@pytest.mark.parametrize("block_rows", [512, 128])
def test_float32_matches_jax_pallas_v6(block_rows):
    """f32, against the TPU production kernel v6 in interpret mode at the
    small Goutsias geometry of tests/test_pallas_stencil.py (supp(x) in
    mask, as v6 assumes).  rtol 1e-5: f32 sums in another order."""
    jm, tm, jb, tb, mask, x = _setup(
        "goutsias", [[2, 6, 0, 2, 0, 0]], [16, 16, 8, 4, 4, 4], seed=23)
    x32 = np.where(mask, x, 0.0).astype(np.float32)
    mv = make_pallas_stencil_matvec_v6(jm, jb, block_rows=block_rows,
                                      interpret=True)
    assert mv is not None
    ref = np.asarray(mv(jnp.asarray(mask), jnp.asarray(x32)))
    m, xt = torch.from_numpy(mask), torch.from_numpy(x32)
    plain = tst.make_stencil_matvec(tm, tb, torch.float32, "cpu")(m, xt)
    assert plain.dtype == torch.float32
    _close(plain.numpy(), ref, 1e-5)
    pack = stencil_cuda.pack_stencil(tm, tb, torch.float32, "cpu")
    _close(stencil_cuda.box_stencil(pack, m, xt).numpy(), ref, 1e-5)


@pytest.mark.parametrize("name,x0,targets", GEOMETRIES)
def test_diag_dilate_face_match_jax(name, x0, targets):
    """Dilation and face detection are exact.  The diagonal agrees to
    2e-15: XLA may contract the factor expressions' multiply-adds (e.g.
    2 + 0.2*Y^2) into FMAs, which torch evaluates as two roundings."""
    jm, tm, jb, tb, mask, _ = _setup(name, x0, targets)
    sparse = np.random.default_rng(3).random(jb.volume) < 0.05
    np.testing.assert_allclose(
        tst.make_diag_fn(tm, tb)(torch.from_numpy(mask)).numpy(),
        np.asarray(jst.make_diag_fn(jm, jb)(jnp.asarray(mask))),
        rtol=2e-15, atol=0,
    )
    jm_, tm_ = jnp.asarray(sparse), torch.from_numpy(sparse)
    for _ in range(3):
        jm_, tm_ = jst.dilate_mask(jb, jm_), tst.dilate_mask(tb, tm_)
        np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
    np.testing.assert_array_equal(
        tst.dilate_mask(tb, tm_, tst.dest_valid_masks(tb)).numpy(),
        np.asarray(jst.dilate_mask(jb, jm_)),
    )
    for m in (sparse, mask, np.zeros_like(mask)):
        np.testing.assert_array_equal(
            tst.active_touches_face(tb, torch.from_numpy(m)),
            jst.active_touches_face(jb, m),
        )


@pytest.mark.parametrize(
    "lam,t_ssa", [(0.0, 1.0), (3.7, 0.25), (150.0, 2.0), (1e4, 10.0),
                  (5.0, -1.0), (0.3, 0.1)]
)
def test_expansion_rounds_match_jax(lam, t_ssa):
    for lo, hi in ((4, 256), (1, 8)):
        assert tst.expansion_rounds(lam, t_ssa, lo, hi) == int(
            jst.expansion_rounds(jnp.float64(lam), jnp.float64(t_ssa), lo, hi)
        )


def test_select_on_cpu_is_plain_version():
    tm = tlib.goutsias_model()
    tb = _grown(TBox, tm.stoichiometry, [[2, 6, 0, 2, 0, 0]], [8, 8, 4, 4, 4, 4])
    for dt in (torch.float64, torch.float32):
        mv = tst.select_stencil_matvec(
            tm, tb, SolverConfig(use_pallas="always"), dt, "cpu")
        assert mv.__qualname__.startswith("make_stencil_matvec.")
    # the JAX selector on a CPU backend likewise takes its XLA stencil
    jm = jlib.goutsias_model()
    jb = _grown(JBox, jm.stoichiometry, [[2, 6, 0, 2, 0, 0]], [8, 8, 4, 4, 4, 4])
    assert jst.select_stencil_matvec(jm, jb, JConfig(), jnp.float64) \
        .__qualname__.startswith("make_stencil_matvec.")


def test_kernel_wrapper_refuses_bad_input():
    tm = tlib.toggle_file_model()
    tb = _grown(TBox, tm.stoichiometry, [[0, 0]], [16, 16])
    with pytest.raises(TypeError):
        stencil_cuda.make_box_stencil_matvec(tm, tb, torch.float16, "cpu")
    pack = stencil_cuda.pack_stencil(tm, tb, torch.float64, "cpu")
    with pytest.raises(ValueError):  # a CUDA operand set needs CUDA tensors
        stencil_cuda.box_stencil(
            pack, torch.zeros(tb.volume, dtype=torch.bool, device="meta"),
            torch.zeros(tb.volume, dtype=torch.float64, device="meta"))
