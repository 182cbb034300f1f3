"""The table backend's state space in the PyTorch port against the JAX
package, on the CPU: packed keys (one int64 word and several), the
``StateTable`` (rows, sorted view and lookups after from_states, merge,
growth and compact, on the native-hash path and on the sorted-merge path),
1-step expansion (the same states in the same order), the native hash
built from the port's own ``csrc/kfs_hash.cpp`` (against a dict), and the
SSA walks, which draw from the port's own random stream and are held to
properties: every state they add is reachable, they explore beyond one
step, and one generator seed gives one result."""

import numpy as np
import pytest
import torch

from krylovfspssa_tpu.statespace.encoding import StateEncoder as JEncoder
from krylovfspssa_tpu.statespace.expand import onestep_extend as j_onestep
from krylovfspssa_tpu.statespace.table import StateTable as JTable
from krylovfspssa_tpu_torch import native
from krylovfspssa_tpu_torch.statespace.encoding import StateEncoder
from krylovfspssa_tpu_torch.statespace.expand import (
    onestep_candidates,
    onestep_extend,
    ssa_extend,
)
from krylovfspssa_tpu_torch.statespace.table import StateTable

torch.set_num_threads(2)

#: (n_species, max_molecules): one-word keys, and keys of 2 and 3 words
ENCODERS = [(2, 10_000), (3, 100), (6, 10_000), (7, 10_000), (13, 10_000)]


def _states(n_species, cap, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cap + 1, size=(n, n_species)).astype(np.int32)


@pytest.mark.parametrize("n_species,max_molecules", ENCODERS)
def test_keys_equal_jax_bit_for_bit(n_species, max_molecules):
    enc = StateEncoder.for_model(n_species, max_molecules)
    jenc = JEncoder.for_model(n_species, max_molecules)
    assert (enc.n_words, enc.bits_per_species, enc.species_cap) == (
        jenc.n_words, jenc.bits_per_species, jenc.species_cap)
    states = _states(n_species, enc.species_cap, 500, n_species)
    # out-of-range rows: -1 and cap + 1 in various species
    states[0, 0] = -1
    states[1, -1] = enc.species_cap + 1
    want = np.array(jenc.encode(states))
    got = enc.encode(torch.as_tensor(states)).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(enc.encode_np(states), want)
    assert np.all(enc.keys_valid(torch.as_tensor(got)).numpy()[2:])
    assert not np.any(enc.keys_valid(torch.as_tensor(got)).numpy()[:2])
    back = enc.decode(torch.as_tensor(want)).numpy()
    np.testing.assert_array_equal(back, np.asarray(jenc.decode(want)))
    np.testing.assert_array_equal(back[2:], states[2:])
    np.testing.assert_array_equal(enc.decode_np(want), back)
    stoich = np.random.default_rng(1).integers(-2, 3, size=(4, n_species))
    np.testing.assert_array_equal(enc.reaction_deltas(stoich),
                                  jenc.reaction_deltas(stoich))
    inv = enc.invalidate(torch.as_tensor(got),
                         torch.arange(500) % 2 == 0).numpy()
    np.testing.assert_array_equal(
        inv, np.asarray(jenc.invalidate(want, np.arange(500) % 2 == 0)))


def _assert_tables_equal(t, j):
    assert (t.n, t.capacity) == (j.n, j.capacity)
    np.testing.assert_array_equal(t.states, np.asarray(j.states))
    np.testing.assert_array_equal(t.keys, np.asarray(j.keys))
    np.testing.assert_array_equal(t.sorted_keys, np.asarray(j.sorted_keys))
    np.testing.assert_array_equal(t.sorted_to_row,
                                  np.asarray(j.sorted_to_row))


@pytest.mark.parametrize("native_index", [True, False])
@pytest.mark.parametrize("n_species,max_molecules,n_words", [
    (2, 1000, 1), (4, 100_000, 2), (6, 10_000, 2), (10, 10_000, 3)])
def test_table_matches_jax(n_species, max_molecules, n_words, native_index):
    """Keys of one word go through the native hash or the numpy sorted
    merge; several words are searched and deduped with torch."""
    enc = StateEncoder.for_model(n_species, max_molecules)
    jenc = JEncoder.for_model(n_species, max_molecules)
    assert enc.n_words == n_words
    init = _states(n_species, 30, 40, 0)
    init = np.concatenate([init, init[:5]])  # duplicates are dropped
    t = StateTable.from_states(init, enc, capacity=16, max_capacity=None,
                               native=native_index)
    j = JTable.from_states(init, jenc, capacity=16)
    _assert_tables_equal(t, j)
    assert (t.host_index is not None) == (native_index and enc.n_words == 1)
    # merge with duplicates, present keys, invalid keys; growth to 512
    new = np.concatenate([_states(n_species, 30, 300, 1), init[:7]])
    new[3, 0] = -1
    keys = enc.encode_np(new)
    t2, added = t.merge_keys(keys, new)
    j2, jadded = j.merge_keys(keys, new)
    assert added == jadded > 0
    _assert_tables_equal(t2, j2)
    assert t2.capacity == 512
    q = np.concatenate([new, _states(n_species, 60, 50, 2)])
    np.testing.assert_array_equal(t2.lookup_states(q),
                                  np.asarray(j2.lookup_states(q)))
    # compact keeps relative order and the capacity
    keep = np.random.default_rng(3).random(t2.n) < 0.6
    t3, remap = t2.compact(keep)
    j3, jremap = j2.compact(keep)
    _assert_tables_equal(t3, j3)
    np.testing.assert_array_equal(remap, np.asarray(jremap))
    np.testing.assert_array_equal(t3.lookup_states(q),
                                  np.asarray(j3.lookup_states(q)))


def test_table_overflow_raises():
    enc = StateEncoder.for_model(1, max_molecules=1000)
    t = StateTable.from_states(np.array([[0]]), enc, capacity=4,
                               max_capacity=8)
    states = np.arange(20)[:, None]
    with pytest.raises(OverflowError):
        t.merge_keys(enc.encode_np(states), states, max_capacity=8)
    with pytest.raises(ValueError):
        StateTable.from_states(np.array([[-1]]), enc, capacity=4)


@pytest.mark.parametrize("n_species,max_molecules", [(2, 1000), (6, 10_000)])
def test_onestep_extend_same_states_in_order(n_species, max_molecules):
    enc = StateEncoder.for_model(n_species, max_molecules)
    jenc = JEncoder.for_model(n_species, max_molecules)
    stoich = np.random.default_rng(4).integers(-1, 2, size=(5, n_species))
    x0 = np.full((1, n_species), 2, np.int32)
    t = StateTable.from_states(x0, enc, capacity=8)
    j = JTable.from_states(x0, jenc, capacity=8)
    for _ in range(4):
        t, added = onestep_extend(t, stoich, None)
        j, jadded = j_onestep(j, stoich, None)
        assert added == jadded
        _assert_tables_equal(t, j)
    assert t.n > 20
    keys, succ = onestep_candidates(t, stoich)
    assert keys.shape[0] == succ.shape[0] == t.n * 5


# ------------------------------------------------------------ native ----


def test_native_hash_against_a_dict():
    rng = np.random.default_rng(0)
    h = native.NativeHashTable(8)  # forces many growth cycles
    oracle, next_row = {}, 0
    for _ in range(20):
        batch = rng.integers(-3, 5000, size=500).astype(np.int64)
        rows, fresh = h.assign_fresh(batch, next_row)
        seen = set()
        for k, r in zip(batch.tolist(), rows.tolist()):
            if k < 0 or k in oracle or k in seen:
                assert r == -1
            else:
                assert r == next_row + len(seen)
                oracle[k] = r
                seen.add(k)
        assert fresh == len(seen)
        next_row += fresh
    assert len(h) == len(oracle)
    q = np.array(list(oracle) + [5001, 9999, -1], dtype=np.int64)
    want = [oracle.get(k, -1) for k in q.tolist()]
    np.testing.assert_array_equal(h.lookup(q), want)
    # insert keeps the first value of a key; delete leaves a reusable slot
    k = np.array(list(oracle)[:3], np.int64)
    np.testing.assert_array_equal(h.insert(k, np.array([7, 8, 9], np.int32)),
                                  [oracle[x] for x in k.tolist()])
    np.testing.assert_array_equal(h.delete(np.concatenate([k, k[:1]])),
                                  [True, True, True, False])
    assert len(h) == len(oracle) - 3
    assert np.all(h.lookup(k) == -1)
    h.insert(k[:1], np.array([77], np.int32))
    assert h.lookup(k[:1])[0] == 77


def test_native_hash_is_built_from_the_port_copy():
    info = native.build()
    assert info.path.parent == native._BUILD
    assert native._SRC.parent.name == "csrc"
    assert native._SRC.parent.parent.name == "krylovfspssa_tpu_torch"
    stamp = info.path.with_name(info.path.name + ".stamp")
    assert stamp.read_text().split("\n")[0] == __import__("hashlib").sha1(
        native._SRC.read_bytes()).hexdigest()


def test_hash_library_from_another_compiler_is_rebuilt(tmp_path,
                                                       monkeypatch):
    """The stamp names the compiler and the machine: a library built
    elsewhere (another g++, another host) is rebuilt, not loaded."""
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    first = native.build()
    assert first.seconds > 0 and first.path.parent == tmp_path / "build"
    assert native.build().seconds == 0.0  # up to date: not rebuilt
    stamp = first.path.with_name(first.path.name + ".stamp")
    lines = stamp.read_text().split("\n")
    assert lines[1].startswith("g++ ") and lines[2]
    stamp.write_text("\n".join([lines[0], "g++ 0.0.0", *lines[2:]]))
    again = native.build()
    assert again.seconds > 0 and stamp.read_text().split("\n") == lines


def test_failed_hash_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "kfs_hash.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.NativeHashTable(16)
    # a one-word table asks for the hash and raises too; the sorted merge
    # is taken only by name
    enc = StateEncoder.for_model(2, 1000)
    with pytest.raises(RuntimeError):
        StateTable.from_states(np.zeros((1, 2)), enc, capacity=8)
    t = StateTable.from_states(np.zeros((1, 2)), enc, capacity=8,
                               native=False)
    assert t.host_index is None and t.n == 1


# --------------------------------------------------------------- SSA ----

#: X moves by 2 (from an odd start it stays odd), Y by 1
SSA_STOICH = np.array([[2, 0], [0, 1], [-2, 0], [0, -1]])


def _ssa_props(states):
    x = states.to(torch.float64)
    n = x.shape[0]
    return torch.stack([torch.full((n,), 10.0, dtype=torch.float64),
                        torch.full((n,), 10.0, dtype=torch.float64),
                        1.0 * x[:, 0], 1.0 * x[:, 1]], dim=1)


def _ssa(seed, origins, max_steps=20, n_species=2, max_molecules=1000):
    enc = StateEncoder.for_model(n_species, max_molecules)
    t = StateTable.from_states(origins, enc, capacity=8)
    g = torch.Generator(device="cpu").manual_seed(seed)
    t2, added = ssa_extend(t, _ssa_props, SSA_STOICH, 5.0, g, max_steps,
                           None)
    return t, t2, added


@pytest.mark.parametrize("max_molecules", [1000, 10_000])
def test_ssa_walks_reach_and_explore(max_molecules):
    """Every added state is reachable from an origin within max_steps
    jumps (X keeps its parity, |dX|/2 + |dY| <= max_steps), the walks go
    beyond the origins' one-step successors, and the seed fixes the
    result (another seed gives another one).  Multi-word keys: the next
    test."""
    origins = np.array([[1, 0], [5, 3]], np.int32)
    t, t2, added = _ssa(0, origins, max_molecules=max_molecules)
    new = t2.states[t.n:t2.n]
    assert added == t2.n - t.n > 20
    assert np.all(new >= 0) and np.all(new[:, 0] % 2 == 1)
    dist = np.min(np.abs(new[:, None, 0] - origins[None, :, 0]) // 2
                  + np.abs(new[:, None, 1] - origins[None, :, 1]), axis=1)
    assert np.all(dist <= 20)
    assert np.any(dist > 1)
    _, t3, added3 = _ssa(0, origins, max_molecules=max_molecules)
    assert added3 == added
    np.testing.assert_array_equal(t3.states, t2.states)
    _, t4, _ = _ssa(1, origins, max_molecules=max_molecules)
    assert not np.array_equal(t4.states[:t4.n], t2.states[:t2.n])


def test_ssa_walks_with_wide_keys():
    stoich = np.zeros((4, 6), np.int64)
    stoich[:, :2] = SSA_STOICH
    enc = StateEncoder.for_model(6, 10_000)
    assert enc.n_words == 2
    origins = np.array([[1, 0, 4, 0, 0, 7]], np.int32)
    t = StateTable.from_states(origins, enc, capacity=8)
    g = torch.Generator().manual_seed(3)
    t2, added = ssa_extend(t, _ssa_props, stoich, 5.0, g, 20, None)
    new = t2.states[t.n:t2.n]
    assert added > 10
    np.testing.assert_array_equal(new[:, 2:], np.broadcast_to(
        origins[:, 2:], new[:, 2:].shape))
    assert np.all(new[:, 0] % 2 == 1)
    # every added state is in the table exactly once, at its own row
    rows = t2.lookup_states(t2.states[:t2.n])
    np.testing.assert_array_equal(rows, np.arange(t2.n))
