"""The port's compact_edges (ops/encrypt.py), the compaction an edge budget
forces, against the JAX package's compact_edges and a brute force over the
same edge tables: scrambled duplicate buckets, buckets that cancel (weight
sum 0 and σ XOR 0, dropped) beside buckets that cancel in one of the two
(kept), the all-distinct case a dot product's root sum hits (a pure
reorder that leaves σ on its device, with or without an edge of weight 0
and σ 0 to drop), with σ held as a host array, a StackedSigma, a LazySigma
over a tensor and a MixedLazySigma over two; and the counters
compact_edges adds (compact.edges in, compact.buckets out, sigma.host_bytes
of rows read from a device-backed σ); a LazySigma's rows brought to the
host a chunk at a time; and views of several σ passes concatenated as a
MixedLazySigma."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pvac_hfhe_cppbyv_tpu import types as jtypes
from pvac_hfhe_cppbyv_tpu.ops import encrypt as jenc
from pvac_hfhe_cppbyv_tpu_torch.core import bits
from pvac_hfhe_cppbyv_tpu_torch.core import field as F
from pvac_hfhe_cppbyv_tpu_torch.ops import encrypt as tenc
from pvac_hfhe_cppbyv_tpu_torch.types import (
    Cipher, LazySigma, MixedLazySigma, StackedSigma, concat_lazy_sigma,
)

P = F.P
B = 7
WORDS = 4


def _key():
    """A public key as compact_edges reads it: B, and an engine's stats."""
    return SimpleNamespace(prm=SimpleNamespace(B=B), _engine=SimpleNamespace(stats={}))


def _limbs(vals):
    return np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(4)] for v in vals],
                    dtype=np.uint32)


def _table(rng, n_layers, n, distinct=False):
    """Edge columns and σ rows; with ``distinct`` every (layer, idx, sign)
    once, in a scrambled order."""
    if distinct:
        keys = rng.permutation(n_layers * B * 2)[:n]
        lid, idx, ch = keys // (2 * B), keys // 2 % B, keys % 2
    else:
        lid = rng.integers(0, n_layers, n)
        idx = rng.integers(0, B, n)
        ch = rng.integers(0, 2, n)
    w = [int(rng.integers(0, 1 << 62)) << 64 | int(rng.integers(0, 1 << 63)) for _ in range(n)]
    sig = rng.integers(0, 1 << 32, (n, WORDS), dtype=np.uint64).astype(np.uint32)
    return [lid.astype(np.int32), idx.astype(np.int32), ch.astype(np.int8), w, sig]


def _cancelling(rng):
    """Buckets of three kinds, scrambled: one whose weights sum to 0 and
    whose σ rows XOR to 0 (dropped), one whose weights sum to 0 only and
    one whose σ rows XOR to 0 only (both kept), beside random edges."""
    lid, idx, ch, w, sig = _table(rng, 2, 40)
    row = rng.integers(0, 1 << 32, WORDS, dtype=np.uint64).astype(np.uint32)
    extra = [  # (layer, idx, sign, weight, σ row)
        (2, 3, 1, 5, row), (2, 3, 1, P - 5, row),              # both cancel
        (2, 4, 0, 9, row), (2, 4, 0, P - 9, row ^ 1),          # weights only
        (2, 5, 1, 9, row), (2, 5, 1, 11, row),                 # σ only
    ]
    lid = np.concatenate([lid, [e[0] for e in extra]]).astype(np.int32)
    idx = np.concatenate([idx, [e[1] for e in extra]]).astype(np.int32)
    ch = np.concatenate([ch, [e[2] for e in extra]]).astype(np.int8)
    w = w + [e[3] for e in extra]
    sig = np.concatenate([sig, np.stack([e[4] for e in extra])])
    perm = rng.permutation(len(lid))
    return [lid[perm], idx[perm], ch[perm], [w[i] for i in perm], sig[perm]]


def _distinct_zero(rng):
    """All-distinct buckets, one of weight 0 and σ 0 (dropped) and one of
    weight 0 alone (kept)."""
    lid, idx, ch, w, sig = _table(rng, 4, 50, distinct=True)
    w[3] = w[11] = 0
    sig[3] = 0
    return [lid, idx, ch, w, sig]


def _brute(table):
    """Bucket by (layer, idx, sign): weights summed mod p, σ XORed; a
    bucket zero in both dropped; buckets in key order."""
    lid, idx, ch, w, sig = table
    acc = {}
    for e in range(len(lid)):
        k = (int(lid[e]) * B + int(idx[e])) * 2 + int(ch[e])
        ws, ss = acc.get(k, (0, np.zeros(WORDS, dtype=np.uint32)))
        acc[k] = ((ws + w[e]) % P, ss ^ sig[e])
    out = [(k, ws, ss) for k, (ws, ss) in sorted(acc.items()) if ws or ss.any()]
    return (np.array([k // (2 * B) for k, _, _ in out]), np.array([k // 2 % B for k, _, _ in out]),
            np.array([k % 2 for k, _, _ in out]), _limbs([ws for _, ws, _ in out]),
            np.stack([ss for _, _, ss in out]))


def _lazy(sig, seed=5):
    """The rows of ``sig`` in a larger base on a tensor, scrambled."""
    base = np.random.default_rng(seed).integers(0, 1 << 32, (len(sig) + 9, WORDS),
                                                dtype=np.uint64).astype(np.uint32)
    rows = np.random.default_rng(seed + 1).permutation(len(base))[:len(sig)]
    base[rows] = sig
    return LazySigma(torch.from_numpy(base.view(np.int32)), rows)


def _holder(kind, sig):
    if kind == "ndarray":
        return sig.copy()
    if kind == "stacked":
        return StackedSigma([sig[:7].copy(), sig[7:19].copy(), sig[19:].copy()])
    if kind == "mixed":  # rows of two bases, interleaved
        odd = np.arange(len(sig)) % 2 == 1
        mixed = concat_lazy_sigma([_lazy(sig[~odd], 5), _lazy(sig[odd], 7)])
        order = np.argsort(np.concatenate([np.nonzero(~odd)[0], np.nonzero(odd)[0]]))
        return mixed[order]
    return _lazy(sig)


def _columns(C):
    return (C.layer_id, C.idx, C.ch, C.w, np.asarray(C.sigma))


CASES = {"duplicates": lambda rng: _table(rng, 3, 300),
         "cancelling": _cancelling,
         "all_distinct": lambda rng: _table(rng, 4, 50, distinct=True),
         "distinct_zero": _distinct_zero}
ON_DEVICE = ("lazy", "mixed")


@pytest.mark.parametrize("holder", ["ndarray", "stacked", "lazy", "mixed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_edges_matches_jax_and_brute_force(case, holder):
    table = CASES[case](np.random.default_rng(sorted(CASES).index(case)))
    lid, idx, ch, w, sig = table
    E = len(lid)
    pk = _key()
    C = Cipher([], lid, idx, ch, _limbs(w), _holder(holder, sig))
    tenc.compact_edges(pk, C)
    J = jtypes.Cipher([], lid, idx, ch, _limbs(w), sig.copy())
    jenc.compact_edges(SimpleNamespace(prm=SimpleNamespace(B=B)), J)
    want = _brute(table)
    for got, jax_col, col in zip(_columns(C), _columns(J), want):
        np.testing.assert_array_equal(got, col)
        np.testing.assert_array_equal(jax_col, col)
    n_out = len(want[0])
    assert n_out == {"all_distinct": E, "distinct_zero": E - 1}.get(case, n_out)
    assert n_out < E or case == "all_distinct"
    stats = pk._engine.stats
    assert stats["compact.edges"] == E and stats["compact.buckets"] == n_out
    assert stats["ns.compact_edges"] > 0
    host = stats.get("sigma.host_bytes", 0)
    if holder not in ON_DEVICE:
        assert host == 0
    elif "distinct" in case:
        # a pure reorder: σ stays a view of its bases, and only the rows of
        # zero weights came to the host to tell a dropped bucket
        assert isinstance(C.sigma, type(_holder(holder, sig)))
        assert host == (2 * WORDS * 4 if case == "distinct_zero" else 0)
    else:
        assert host == E * WORDS * 4


def test_cancelling_bucket_is_dropped_and_half_cancelling_ones_kept():
    table = _cancelling(np.random.default_rng(1))
    C = Cipher([], *table[:3], _limbs(table[3]), table[4])
    tenc.compact_edges(_key(), C)
    keys = set(zip(C.layer_id.tolist(), C.idx.tolist(), C.ch.tolist()))
    assert (2, 3, 1) not in keys and {(2, 4, 0), (2, 5, 1)} <= keys


def test_budget_guard_compacts_only_past_the_budget():
    table = _table(np.random.default_rng(2), 3, 300)
    for budget, compacted in ((300, False), (299, True)):
        pk = _key()
        pk.prm.edge_budget = budget
        C = Cipher([], *table[:3], _limbs(table[3]), table[4])
        tenc.guard_budget(pk, C, "test")
        assert (C.n_edges < 300) == compacted
        assert pk._engine.stats.get("compact.edges", 0) == (300 if compacted else 0)


@pytest.mark.parametrize("chunk_rows", [1, 3, 64])
def test_lazy_rows_reach_the_host_alike_in_chunks(monkeypatch, chunk_rows):
    """A LazySigma's rows come to the host a chunk at a time (through a
    pinned buffer on a card) from PINNED_MIN_BYTES up, in one copy below:
    the same rows either way, the producer's fixup applied, in one chunk
    or many, and none."""
    sig = np.random.default_rng(7).integers(0, 1 << 32, (50, WORDS),
                                            dtype=np.uint64).astype(np.uint32)
    lazy = _holder("lazy", sig)
    np.testing.assert_array_equal(np.asarray(lazy), sig)  # one copy
    monkeypatch.setattr(bits, "PINNED_MIN_BYTES", 0)
    monkeypatch.setattr(bits, "PINNED_CHUNK_BYTES", chunk_rows * WORDS * 4)
    np.testing.assert_array_equal(bits.rows_to_np_u32(lazy.base, lazy.rows), sig)
    assert bits.rows_to_np_u32(lazy.base, lazy.rows[:0]).shape == (0, WORDS)

    def fixup(out, rows):
        out[rows == rows[5]] = 7
        return out

    fixed = LazySigma(lazy.base, lazy.rows, fixup)
    pk = _key()
    got = tenc._sigma_host(pk, fixed)
    want = sig.copy()
    want[5] = 7
    np.testing.assert_array_equal(got, want)
    assert pk._engine.stats["sigma.host_bytes"] == sig.nbytes


def test_views_of_several_passes_concatenate_on_the_device():
    """Ciphertext σ from different σ passes concatenates as a
    MixedLazySigma, with no row read: each base once, rows, fixups and
    salts kept through slices and permutations; views of one pass stay a
    LazySigma."""
    rng = np.random.default_rng(9)
    sig = rng.integers(0, 1 << 32, (30, WORDS), dtype=np.uint64).astype(np.uint32)
    a, b, c = _lazy(sig[:10], 11), _lazy(sig[10:20], 13), _lazy(sig[20:], 15)
    for v, seed in ((a, 1), (b, 2), (c, 3)):
        v.salt = np.random.default_rng(seed).integers(0, 1 << 62, len(v.base), dtype=np.uint64)

    def fixup(out, rows):
        out[rows == c.rows[4]] = 3
        return out

    c.fixup = fixup
    want = sig.copy()
    want[24] = 3
    pk = _key()
    ab = tenc._concat_sigma(pk, a, b)
    abc = tenc._concat_sigma(pk, ab, c)
    aba = tenc._concat_sigma(pk, ab, a[2:5])
    assert isinstance(abc, MixedLazySigma) and len(abc.srcs) == 3 and len(aba.srcs) == 2
    assert "sigma.host_bytes" not in pk._engine.stats
    np.testing.assert_array_equal(np.asarray(abc), want)
    np.testing.assert_array_equal(np.asarray(aba), np.concatenate([sig[:20], sig[2:5]]))
    perm = rng.permutation(30)
    np.testing.assert_array_equal(np.asarray(abc[perm]), want[perm])
    np.testing.assert_array_equal(np.asarray(abc[5:25]), want[5:25])
    salts = np.concatenate([v.salts for v in (a, b, c)])
    np.testing.assert_array_equal(abc[perm].salts, salts[perm])
    one = concat_lazy_sigma([a[:4], a[6:]])
    assert isinstance(one, LazySigma) and one.base is a.base
    np.testing.assert_array_equal(np.asarray(one), np.concatenate([sig[:4], sig[6:10]]))
