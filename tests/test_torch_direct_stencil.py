"""PyTorch port vs JAX package: the direct-form stencil for models whose
propensities do not factor per species (custom propensity callables and
coupled expressions), and the packed operands of the ``direct_stencil``
CUDA kernel (the stored diagonal and the destination-indexed rate
fields).  Float64 against the JAX XLA stencil; float32 against the
TPU kernels B5 (``make_pallas_stencil_matvec_v2``) and B6
(``make_pallas_stencil_matvec``) in interpret mode.  The kernel itself is
compared with its plain version on the card in
tests/test_torch_stencil_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu.boxspace.box import BoxSpace as JBox
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu.models.factorize import factorize_model as jfactorize
from krylovfspssa_tpu.models.model import Model as JModel
from krylovfspssa_tpu.ops import stencil as jst
from krylovfspssa_tpu.ops.pallas_stencil import (
    make_pallas_stencil_matvec,
    make_pallas_stencil_matvec_v2,
)
from krylovfspssa_tpu_torch.boxspace.box import BoxSpace as TBox
from krylovfspssa_tpu_torch.config import SolverConfig
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.models.factorize import factorize_model
from krylovfspssa_tpu_torch.models.model import Model as TModel
from krylovfspssa_tpu_torch.ops import stencil as tst
from krylovfspssa_tpu_torch.ops import stencil_cuda

torch.set_num_threads(2)


def _coupled(model_cls):
    """A toggle whose X production is repressed by the product X*Y: no
    per-species factorization exists."""
    return model_cls(
        n_species=2, n_reactions=4, n_parameters=4,
        stoichiometry=np.array([[1, 0], [-1, 0], [0, 1], [0, -1]]),
        species_names=["X", "Y"], parameter_names=["kx", "dx", "ky", "dy"],
        propensity_expressions=["kx/(1.0 + 0.1*X*Y)", "dx*X",
                                "ky/(1.0 + 0.5*X)", "dy*Y"],
        parameters=[50.0, 1.0, 40.0, 1.0], name="coupled",
    )


_MODELS = {
    "toggle_programmatic": (jlib.toggle_programmatic_model,
                            tlib.toggle_programmatic_model),
    "ge5d": (jlib.ge5d_model, tlib.ge5d_model),
    "coupled": (lambda: _coupled(JModel), lambda: _coupled(TModel)),
}

# (model, x0, per-species extents): boxes of 2^11-2^13 cells, each a
# multiple of 128 cells with at least 8 rows (the TPU kernels' layout)
GEOMETRIES = [
    ("toggle_programmatic", [[0, 0]], [64, 64]),
    ("ge5d", [[0, 0, 0, 0, 0]], [8, 8, 4, 8, 4]),
    ("coupled", [[0, 0]], [32, 64]),
]


def _grown(box_cls, stoich, x0, targets):
    box = box_cls.for_model(stoich, x0)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    return box


def _setup(name, x0, targets, seed=0):
    jm, tm = (mk() for mk in _MODELS[name])
    jb = _grown(JBox, jm.stoichiometry, x0, targets)
    tb = _grown(TBox, tm.stoichiometry, x0, targets)
    rng = np.random.default_rng(seed)
    mask = rng.random(jb.volume) < 0.6
    x = rng.random(jb.volume)
    return jm, tm, jb, tb, mask, x


def _face_mask(box, mask):
    """``mask`` with every cell on every face of the box switched on: the
    cells where a predecessor leaves the box and the validity test of the
    kernel decides."""
    m = mask.reshape(box.shape).copy()
    for ax in range(len(box.shape)):
        sl = [slice(None)] * len(box.shape)
        for edge in (0, -1):
            sl[ax] = edge
            m[tuple(sl)] = True
    return m.reshape(-1)


def _close(got, ref, rtol):
    """max |got - ref| <= rtol * max |ref| (relative to the output scale)."""
    scale = float(np.max(np.abs(ref)))
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(ref))))
    assert err <= rtol * scale, (err, scale)


def _jax_matvec(jm, jb, mask, x, dtype=jnp.float64):
    return np.asarray(jst.make_stencil_matvec(jm, jb, dtype)(
        jnp.asarray(mask), jnp.asarray(x.astype(dtype))))


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_models_are_not_separable(name):
    """Both packages refuse to factorize each model, so the direct form
    (and on a GPU, direct_stencil) is the one that runs."""
    jm, tm = (mk() for mk in _MODELS[name])
    assert jfactorize(jm) is None and factorize_model(tm) is None


@pytest.mark.parametrize("name,x0,targets", GEOMETRIES)
def test_direct_form_matches_jax_f64(name, x0, targets):
    """The plain direct-form matvec and the diagonal against the JAX XLA
    stencil, in float64 at rtol 1e-12."""
    jm, tm, jb, tb, mask, x = _setup(name, x0, targets)
    ref = _jax_matvec(jm, jb, mask, x)
    got = tst.make_stencil_matvec(tm, tb, torch.float64, "cpu")(
        torch.from_numpy(mask), torch.from_numpy(x))
    _close(got.numpy(), ref, 1e-12)
    np.testing.assert_allclose(
        tst.make_diag_fn(tm, tb)(torch.from_numpy(mask)).numpy(),
        np.asarray(jst.make_diag_fn(jm, jb)(jnp.asarray(mask))),
        rtol=1e-12, atol=0,
    )


@pytest.mark.parametrize("dt,rtol", [(torch.float64, 1e-12),
                                     (torch.float32, 1e-5)])
@pytest.mark.parametrize("name,x0,targets", GEOMETRIES)
def test_packed_operands_match_plain_with_active_faces(name, x0, targets, dt,
                                                      rtol):
    """direct_stencil on CPU tensors — the kernel's arithmetic over its
    stored diagonal, destination-indexed rates and offsets — against
    make_stencil_matvec and the JAX stencil, with every face of the box
    active.  Rates rolled from the propensity fields without the validity
    zeroing give another y on the same inputs, so the geometry does
    exercise the validity baked into the rates."""
    jm, tm, jb, tb, mask, x = _setup(name, x0, targets, seed=5)
    mask = _face_mask(tb, mask)
    m = torch.from_numpy(mask)
    xt = torch.from_numpy(x).to(dt)
    pack = stencil_cuda.pack_direct_stencil(tm, tb, dt, "cpu")
    assert pack.rates.shape == (tm.n_reactions, tb.volume)
    assert pack.diag.shape == (tb.volume,)
    assert pack.rates.dtype == pack.diag.dtype == dt
    assert pack.meta.dtype == torch.int32
    before = stencil_cuda.DIRECT_LAUNCHES
    got = stencil_cuda.direct_stencil(pack, m, xt)
    assert stencil_cuda.DIRECT_LAUNCHES == before  # no kernel on a CPU tensor
    assert got.dtype == dt
    plain = tst.make_stencil_matvec(tm, tb, dt, "cpu")(m, xt)
    _close(got.numpy(), plain.numpy(), rtol)
    _close(got.numpy(), _jax_matvec(jm, jb, mask, x), rtol)

    fields = tst.propensity_fields(tm, tb, dt, "cpu")
    unmasked = torch.stack([torch.roll(f, int(off))
                            for f, off in zip(fields, tb.offsets)])
    blind = stencil_cuda.direct_stencil(
        dataclasses.replace(pack, rates=unmasked), m, xt)
    scale = float(torch.max(torch.abs(plain)))
    assert float(torch.max(torch.abs(blind - plain))) > 1e-3 * scale


@pytest.mark.parametrize("chunk", [None, 384], ids=["whole", "chunked"])
@pytest.mark.parametrize("name,x0,targets", [
    ("toggle_programmatic", [[0, 0]], [64, 128]),
    ("ge5d", [[0, 0, 0, 0, 0]], [8, 8, 4, 8, 4]),
])
def test_pack_matches_jax_propensity_fields(monkeypatch, name, x0, targets,
                                            chunk):
    """The pack's diagonal and rates against the JAX package's
    make_propensity_evaluator, summed in k order, and rolled and
    validity-masked in numpy, in float64 at rtol 1e-12; and the pack's
    y against the JAX stencil with every face of the box active.
    ``chunked``: the fields evaluated 384 cells at a time (a ragged last
    chunk)."""
    if chunk is not None:
        monkeypatch.setattr(stencil_cuda, "_FIELD_CHUNK", chunk)
    jm, tm, jb, tb, mask, x = _setup(name, x0, targets, seed=7)
    evaluate = jst.make_propensity_evaluator(jm, jb, jnp.float64)
    z = np.arange(jb.volume)
    fields = [np.broadcast_to(np.asarray(evaluate(jnp.asarray(z), k)),
                              z.shape) for k in range(jm.n_reactions)]
    diag = np.zeros(jb.volume)
    for f in fields:
        diag = diag + f
    stoich = np.asarray(jb.stoichiometry)
    rates = []
    for k, f in enumerate(fields):
        valid = np.ones(jb.volume, bool)
        for s in np.nonzero(stoich[k])[0]:
            ext = 1 << int(jb.bits_of_species[s])
            pred = ((z >> int(jb.shift_of_species[s])) & (ext - 1)) \
                - stoich[k, s]
            valid &= (pred >= 0) & (pred < ext)
        rates.append(np.where(valid, np.roll(f, int(jb.offsets[k])), 0.0))
    pack = stencil_cuda.pack_direct_stencil(tm, tb, torch.float64, "cpu")
    assert pack.meta.tolist() == [int(o) for o in jb.offsets]
    np.testing.assert_allclose(pack.diag.numpy(), diag, rtol=1e-12, atol=0)
    np.testing.assert_allclose(pack.rates.numpy(), np.stack(rates),
                               rtol=1e-12, atol=0)
    mask = _face_mask(tb, mask)
    got = stencil_cuda.direct_stencil(pack, torch.from_numpy(mask),
                                      torch.from_numpy(x))
    _close(got.numpy(), _jax_matvec(jm, jb, mask, x), 1e-12)


@pytest.mark.parametrize(
    "tpu_kernel", [make_pallas_stencil_matvec_v2, make_pallas_stencil_matvec],
    ids=["B5_v2", "B6_v1"])
@pytest.mark.parametrize("name,x0,targets", GEOMETRIES)
def test_float32_matches_jax_pallas(name, x0, targets, tpu_kernel):
    """f32: the plain version and the packed-operand path against the TPU
    kernels B5 and B6 in interpret mode (block_rows=16), atol 2e-6 x
    max|y| as tests/test_pallas_stencil.py holds them against XLA."""
    jm, tm, jb, tb, mask, x = _setup(name, x0, targets, seed=3)
    x32 = x.astype(np.float32)
    mv = tpu_kernel(jm, jb, block_rows=16, interpret=True)
    ref = np.asarray(mv(jnp.asarray(mask), jnp.asarray(x32)))
    m, xt = torch.from_numpy(mask), torch.from_numpy(x32)
    plain = tst.make_stencil_matvec(tm, tb, torch.float32, "cpu")(m, xt)
    assert plain.dtype == torch.float32
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(plain.numpy(), ref, atol=2e-6 * scale)
    pack = stencil_cuda.pack_direct_stencil(tm, tb, torch.float32, "cpu")
    np.testing.assert_allclose(
        stencil_cuda.direct_stencil(pack, m, xt).numpy(), ref,
        atol=2e-6 * scale)


def test_separable_model_through_direct_operands():
    """A separable model packed for direct_stencil gives the y of the
    destination form (the tie the card checks between the two kernels at
    the 2^22-cell Goutsias box)."""
    tm = tlib.goutsias_model()
    tb = _grown(TBox, tm.stoichiometry, [[2, 6, 0, 2, 0, 0]],
                [16, 16, 8, 4, 4, 4])
    rng = np.random.default_rng(9)
    m = torch.from_numpy(_face_mask(tb, rng.random(tb.volume) < 0.6))
    x = torch.from_numpy(rng.random(tb.volume))
    ref = stencil_cuda.box_stencil(
        stencil_cuda.pack_stencil(tm, tb, torch.float64, "cpu"), m, x)
    got = stencil_cuda.direct_stencil(
        stencil_cuda.pack_direct_stencil(tm, tb, torch.float64, "cpu"), m, x)
    _close(got.numpy(), ref.numpy(), 1e-12)


def test_select_on_cuda_routes_by_separability(monkeypatch):
    """On a CUDA device the selector takes direct_stencil for every model
    that factorize_model refuses and box_stencil for the rest (the
    factories are replaced by markers: this host has no card)."""
    monkeypatch.setattr(stencil_cuda, "make_direct_stencil_matvec",
                        lambda *a: "direct_stencil")
    monkeypatch.setattr(stencil_cuda, "make_box_stencil_matvec",
                        lambda *a: "box_stencil")
    cases = [(tlib.toggle_programmatic_model(), "direct_stencil"),
             (tlib.ge5d_model(), "direct_stencil"),
             (_coupled(TModel), "direct_stencil"),
             (tlib.toggle_file_model(), "box_stencil"),
             (tlib.goutsias_model(), "box_stencil")]
    for model, kernel in cases:
        box = TBox.for_model(model.stoichiometry, [[0] * model.n_species])
        for dt in (torch.float64, torch.float32):
            assert tst.select_stencil_matvec(
                model, box, SolverConfig(), dt, "cuda") == kernel


def test_direct_wrapper_refuses_bad_input():
    tm = tlib.ge5d_model()
    tb = _grown(TBox, tm.stoichiometry, [[0] * 5], [4, 4, 4, 4, 4])
    with pytest.raises(TypeError):
        stencil_cuda.make_direct_stencil_matvec(tm, tb, torch.float16, "cpu")
    with pytest.raises(ValueError, match="not separable"):
        stencil_cuda.pack_stencil(tm, tb, torch.float64, "cpu")
    pack = stencil_cuda.pack_direct_stencil(tm, tb, torch.float64, "cpu")
    with pytest.raises(ValueError):  # a CUDA operand set needs CUDA tensors
        stencil_cuda.direct_stencil(
            pack, torch.zeros(tb.volume, dtype=torch.bool, device="meta"),
            torch.zeros(tb.volume, dtype=torch.float64, device="meta"))
