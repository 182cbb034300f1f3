"""The host side of the separable stencil kernel (csrc/sep_stencil.cuh): its
(tile, reaction) row-factor table, its int32 meta of per-cell factors, and
the kernel's arithmetic replayed in numpy from that meta as the kernel
reads it.  The kernel itself runs only on the card
(tests/test_torch_stencil_cuda.py, tests/test_torch_halo_cuda.py); here the
replay must agree with the plain version, and the replayed shards of a box
must equal the replayed box bit for bit.  Inputs come from
``numpy.random.default_rng(seed)`` and meet the kernel's contract
``supp(x) ⊆ mask``."""

import numpy as np
import pytest
import torch

from krylovfspssa_tpu_torch import load_model
from krylovfspssa_tpu_torch.boxspace.box import BoxSpace
from krylovfspssa_tpu_torch.models import library
from krylovfspssa_tpu_torch.ops import stencil_cuda as sc
from krylovfspssa_tpu_torch.ops.halo import halo_from_global, halo_width

torch.set_num_threads(2)

GE5D_INPUT = "models/ge5d_model.input"

#: name -> (model factory, x0, per-species extents, min log2)
GEOMETRIES = {
    "goutsias-2^22": (library.goutsias_model, [[2, 6, 0, 2, 0, 0]],
                      [64, 64, 16, 4, 4, 4], 2),
    "toggle-512x512": (library.toggle_file_model, [[0, 0]], [512, 512], 2),
    # the box the ge5d t=1 solve ends in (chip_smoke.py [ge5d-input])
    "ge5d-input": (GE5D_INPUT, [[0, 0, 0, 0, 0]], [32, 32, 32, 16, 16], 2),
    "repressilator-128": (library.repressilator_model, [[0, 0, 0]],
                          [4, 4, 8], 2),
    "goutsias-small": (library.goutsias_model, [[2, 6, 0, 2, 0, 0]],
                       [16, 16, 8, 4, 4, 4], 2),
    "toggle-2x8": (library.toggle_file_model, [[0, 0]], [2, 8], 1),
    "bursting_gene": (library.bursting_gene_model, [[0, 0]], [4, 64], 2),
}


def _model(factory):
    if factory == GE5D_INPUT:
        from pathlib import Path

        model = load_model(Path(__file__).resolve().parent.parent / factory)
        model.reset_parameters(library.ge5d_model().parameters)
        return model
    return factory()


def _box(name):
    factory, x0, targets, min_log2 = GEOMETRIES[name]
    model = _model(factory)
    box = BoxSpace.for_model(model.stoichiometry, x0, min_log2)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    return model, box


def _records(pack):
    """[(off_k, per-cell factors of reaction k)] as the kernel slices its
    meta: off[R] | start[R + 1] | (shift, ext - 1, table offset) each."""
    meta, R = pack.cell_meta.numpy(), pack.n_reactions
    off, start = meta[:R], meta[R:2 * R + 1]
    fac = meta[2 * R + 1:].reshape(-1, 3)
    assert start[0] == 0 and start[-1] == len(fac)
    return [(int(off[k]), [tuple(int(v) for v in f)
                           for f in fac[start[k]:start[k + 1]]])
            for k in range(R)]


def _replay(pack, mask, x, left, right):
    """The kernel's y on the pack's rows in numpy, from its meta: -D*x,
    then per reaction F[tile, k] (skipped where 0) times the per-cell
    factors, times src(i - off_k) from x, the halos or 0 beyond them."""
    n, hl = pack.rows, left.numel()
    xs, tab = x.numpy(), pack.tables.numpy()
    rowf = pack.row_factors.numpy()
    src = np.concatenate([left.numpy(), xs, right.numpy()])
    i = np.arange(n)
    z = pack.z0 + i
    t = (z >> pack.log2_tile) - (pack.z0 >> pack.log2_tile)
    acc = -pack.diag.numpy() * xs
    for k, (off, cell) in enumerate(_records(pack)):
        u = rowf[t, k]
        for shift, emask, toff in cell:
            u = u * tab[toff + ((z >> shift) & emask)]
        j = i - off
        inside = (j >= -hl) & (j < n + hl)
        v = np.where(inside, src[np.clip(j + hl, 0, src.size - 1)], 0)
        acc = acc + np.where(u != 0, u * v, 0)
    return np.where(mask.numpy(), acc, 0).astype(xs.dtype)


def _inputs(box, dt, seed=0, corner=False):
    """A random mask (60% of cells) with every face of the box active, or
    (``corner``) 60% of the cells of the box's low corner, a quarter of
    each extent, as an FSP's support is, so that whole tiles are empty;
    and random x inside the mask."""
    rng = np.random.default_rng(seed)
    m = (rng.random(box.volume) < 0.6).reshape(box.shape)
    if corner:
        for ax, n in enumerate(box.shape):
            sl = [slice(None)] * len(box.shape)
            sl[ax] = slice(max(1, n // 4), None)
            m[tuple(sl)] = False
    for ax in range(len(box.shape) * (not corner)):
        sl = [slice(None)] * len(box.shape)
        for edge in (0, -1):
            sl[ax] = edge
            m[tuple(sl)] = True
    mask = torch.from_numpy(m.reshape(-1))
    x = torch.from_numpy(rng.random(box.volume)).to(dt)
    return mask, torch.where(mask, x, 0)


def _shards(model, box, dt, n_ranks, mask, x):
    """(pack, mask, x, left, right) of each of n_ranks row shards."""
    H, L = halo_width(box), box.volume // n_ranks
    for r in range(n_ranks):
        z0 = r * L
        pack = sc.pack_halo_stencil(model, box, dt, "cpu", z0, L)
        yield (pack, mask[z0:z0 + L], x[z0:z0 + L],
               *halo_from_global(x, z0, L, H))


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["goutsias-2^22", "toggle-512x512",
                                  "repressilator-128", "ge5d-input",
                                  "toggle-2x8"])
def test_plan_covers_every_source(name, dt):
    """Every source a cell reads lies in its rows, in a halo, or outside the
    box where its rate is 0; the meta holds each reaction's offset and
    exactly its factors below the tile; and the row-factor tiles of each
    row shard (P = 1, 2, 4, 8; at toggle-2x8 the halo is wider than the
    shards) are the box's tiles, at global multiples of T."""
    model, box = _box(name)
    pack = sc.pack_stencil(model, box, dt, "cpu")
    H, T = halo_width(box), 1 << pack.log2_tile
    assert T <= box.volume and pack.n_tiles == box.volume // T
    records = _records(pack)
    assert [off for off, _ in records] == [int(o) for o in box.offsets]
    for k, (_, got) in enumerate(records):
        assert got == list(pack.cell_factors(k))
        assert sorted(got + list(pack.tile_factors(k))) == sorted(
            pack.factors[k])
        assert all(f[0] >= pack.log2_tile for f in pack.tile_factors(k))
    z = torch.arange(box.volume, dtype=torch.int64)
    for n_ranks in (1, 2, 4, 8):
        L = box.volume // n_ranks
        for r in range(n_ranks):
            hp = sc.pack_halo_stencil(model, box, dt, "cpu", r * L, L)
            assert hp.log2_tile == pack.log2_tile
            assert torch.equal(hp.cell_meta, pack.cell_meta)
            g0 = (r * L) >> hp.log2_tile
            assert torch.equal(hp.row_factors,
                               pack.row_factors[g0:g0 + hp.n_tiles])
            zl = z[r * L:(r + 1) * L]
            for k, off in enumerate(box.offsets):
                j = zl - r * L - int(off)
                outside = (j < -H) | (j >= L + H)
                # a source beyond the halos is outside the box: rate 0
                assert not (sc._rate(hp, k, zl)[outside] != 0).any()
                g = zl - int(off)
                gone = (g < 0) | (g >= box.volume)
                assert not (sc._rate(hp, k, zl)[gone] != 0).any()


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["goutsias-2^22", "toggle-512x512",
                                  "repressilator-128", "ge5d-input"])
def test_row_factors_times_cell_factors(name, dt):
    """F[tile, k] times the per-cell factors equals const_k times every
    factor of reaction k (the plain version's rate), to 1e-14 relative in
    float64 (the product is taken in another order) and 1e-6 in float32,
    at every cell, for the box and for each of 4 shards."""
    model, box = _box(name)
    pack = sc.pack_stencil(model, box, dt, "cpu")
    rtol = 1e-14 if dt == torch.float64 else 1e-6
    z = torch.arange(box.volume, dtype=torch.int64)
    L = box.volume // 4
    shards = [sc.pack_halo_stencil(model, box, dt, "cpu", r * L, L)
              for r in range(4)]
    for k in range(pack.n_reactions):
        ref = sc._propensity(pack, k, z)
        got = sc._rate(pack, k, z)
        err = float(torch.max(torch.abs(got - ref)))
        assert err <= rtol * float(torch.max(torch.abs(ref))), (k, err)
        parts = [sc._rate(hp, k, z[hp.z0:hp.z0 + L]) for hp in shards]
        assert torch.equal(torch.cat(parts), got)


SMALL = ["goutsias-small", "toggle-2x8", "bursting_gene",
         "repressilator-128"]


@pytest.mark.parametrize("corner", [False, True], ids=["dense", "corner"])
@pytest.mark.parametrize("dt,rtol", [(torch.float64, 1e-12),
                                     (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", SMALL)
def test_replayed_walk_equals_plain(name, dt, rtol, corner):
    """The kernel's arithmetic, replayed from its meta, agrees with the
    plain version to rtol x max|y| on the whole box and on every row shard
    (P = 2, 4, 8; at toggle-2x8 the halo is wider than the shards), and
    the replayed shards equal the replayed box bit for bit; with a dense
    mask and with one that leaves whole tiles empty."""
    model, box = _box(name)
    mask, x = _inputs(box, dt, corner=corner)
    pack = sc.pack_stencil(model, box, dt, "cpu")
    zero = torch.zeros(0, dtype=dt)
    ref = sc.box_stencil(pack, mask, x).numpy()
    scale = float(np.abs(ref).max())
    got = _replay(pack, mask, x, zero, zero)
    assert float(np.abs(got - ref).max()) <= rtol * scale
    for n_ranks in (2, 4, 8):
        parts = []
        for hp, m, xl, left, right in _shards(model, box, dt, n_ranks, mask,
                                              x):
            part = _replay(hp, m, xl, left, right)
            plain = sc.halo_stencil(hp, m, xl, left, right).numpy()
            assert float(np.abs(part - plain).max()) <= rtol * scale
            parts.append(part)
        np.testing.assert_array_equal(np.concatenate(parts), got)


@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_replayed_walk_at_the_goutsias_box(n_ranks):
    """At the 2^22-cell Goutsias box (float64), where the far sources reach
    into the halos or out of the box: each shard's replay agrees with the
    plain version to 1e-12 x max|y|, and the shards together equal the
    replayed box bit for bit."""
    model, box = _box("goutsias-2^22")
    dt = torch.float64
    mask, x = _inputs(box, dt, seed=4)
    zero = torch.zeros(0, dtype=dt)
    whole = _replay(sc.pack_stencil(model, box, dt, "cpu"), mask, x, zero,
                    zero)
    parts = []
    for hp, m, xl, left, right in _shards(model, box, dt, n_ranks, mask, x):
        part = _replay(hp, m, xl, left, right)
        plain = sc.halo_stencil(hp, m, xl, left, right).numpy()
        assert float(np.abs(part - plain).max()) <= 1e-12 * float(
            np.abs(plain).max())
        parts.append(part)
    np.testing.assert_array_equal(np.concatenate(parts), whole)
