"""The port's recipe-backed σ (types.VirtualSigma), case by case as the
JAX package's tests/test_virtual_sigma.py holds its own, plus its rows
against the JAX σ generator.

A product past SIGMA_EAGER_MAX edges keeps the recipe of its σ; rows
generated from it must equal eager generation bit for bit.  The cases
set SIGMA_EAGER_MAX to 1 so every product is virtual.  Exact throughout
(tolerance 0) except the sampled density, held within 0.02 of the exact
one, as in the JAX test."""
import dataclasses

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
from pvac_hfhe_cppbyv_tpu.crypto import matrix as jmatrix
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.crypto import matrix
from pvac_hfhe_cppbyv_tpu_torch.ops import arithmetic as arith
from pvac_hfhe_cppbyv_tpu_torch.ops import recrypt as rc
from pvac_hfhe_cppbyv_tpu_torch.ops.encrypt import compact_edges, sigma_density
from pvac_hfhe_cppbyv_tpu_torch.types import Cipher, VirtualSigma, concat_virtual_sigma

torch.set_num_threads(2)

P = (1 << 127) - 1


def _carry(pk, sk):
    pkf = dict(prm=dataclasses.asdict(pk.prm), canon_tag=pk.canon_tag, H=pk.H,
               ubk_perm=pk.ubk.perm, ubk_inv=pk.ubk.inv, H_digest=pk.H_digest,
               omega_B=pk.omega_B, powg_B=pk.powg_B)
    return tpv.keys_from_numpy(pkf, dict(prf_k=sk.prf_k, lpn_s_bits=sk.lpn_s_bits), device="cpu")


@pytest.fixture(scope="module")
def keys():
    jpk, jsk = jpv.keygen(jpv.small_test_params())
    return jpk, jsk, *_carry(jpk, jsk)


@pytest.fixture
def virtual_everything(monkeypatch):
    monkeypatch.setattr(arith, "SIGMA_EAGER_MAX", 1)


def _product(pk, sk, a, b):
    return tpv.ct_mul(pk, *tpv.enc_value_batch(pk, sk, [a, b]))


def test_mul_chain_stays_virtual_and_decrypts(keys, virtual_everything):
    jpk, jsk, pk, sk = keys
    prod = _product(pk, sk, 123, 456)
    assert isinstance(prod.sigma, VirtualSigma)
    assert tpv.dec_value(pk, sk, prod) == 123 * 456 % P
    sq = tpv.ct_mul(pk, prod, prod)
    assert isinstance(sq.sigma, VirtualSigma)
    assert tpv.dec_value(pk, sk, sq) == pow(123 * 456, 2, P)


def test_add_concat_and_density(keys, virtual_everything):
    jpk, jsk, pk, sk = keys
    ca, cb = tpv.enc_value_batch(pk, sk, [7, 9])
    p1, p2 = tpv.ct_mul(pk, ca, cb), tpv.ct_mul(pk, ca, cb)
    s = tpv.ct_add(pk, p1, p2)
    assert isinstance(s.sigma, VirtualSigma)
    assert np.array_equal(np.asarray(s.sigma),
                          np.concatenate([np.asarray(p1.sigma), np.asarray(p2.sigma)]))
    assert tpv.dec_value(pk, sk, s) == 2 * 63
    assert 0.4 < sigma_density(pk, p1) < 0.6  # the streamed popcount


def test_compact_pure_reorder_keeps_virtual(keys, virtual_everything):
    jpk, jsk, pk, sk = keys
    prod = _product(pk, sk, 3, 5)
    before = np.asarray(prod.sigma)
    key = np.lexsort((prod.ch, prod.idx, prod.layer_id))
    rng = np.random.default_rng(2)
    perm = rng.permutation(prod.n_edges)  # scramble, so the reorder shows
    for col in ("layer_id", "idx", "ch", "w", "sigma"):
        setattr(prod, col, getattr(prod, col)[perm])
    compact_edges(pk, prod)
    assert isinstance(prod.sigma, VirtualSigma)
    # σ rows followed their edges back into (layer, idx, sign) order
    assert np.array_equal(np.asarray(prod.sigma), before[key])
    assert tpv.dec_value(pk, sk, prod) == 15


def test_compact_merge_materializes(keys, virtual_everything):
    """Doubling a product's edge table duplicates every bucket: compaction
    takes the eager merge (weights sum, σ XOR)."""
    jpk, jsk, pk, sk = keys
    prod = _product(pk, sk, 3, 5)
    dup = prod.copy()
    doubled = Cipher(
        [type(L)(L.rule, L.seed, L.pa, L.pb) for L in prod.layers],
        np.concatenate([prod.layer_id, dup.layer_id]),
        np.concatenate([prod.idx, dup.idx]),
        np.concatenate([prod.ch, dup.ch]),
        np.concatenate([prod.w, dup.w]),
        concat_virtual_sigma([prod.sigma, dup.sigma]),
    )
    n_before = doubled.n_edges
    compact_edges(pk, doubled)
    assert doubled.n_edges == n_before // 2
    assert isinstance(doubled.sigma, np.ndarray)
    assert not doubled.sigma.any()  # XOR of identical rows cancels
    assert tpv.dec_value(pk, sk, doubled) == 30


def test_serialization_materializes_deterministically(keys, virtual_everything, tmp_path):
    jpk, jsk, pk, sk = keys
    prod = _product(pk, sk, 11, 13)
    sig = np.asarray(prod.sigma)
    tpv.save_cts([prod], str(tmp_path / "p.ct"))
    back = tpv.load_cts(str(tmp_path / "p.ct"))[0]
    assert np.array_equal(np.asarray(back.sigma), sig)
    assert tpv.dec_value(pk, sk, back) == 143
    # and through the JAX package
    (jback,) = jpv.load_cts(str(tmp_path / "p.ct"))
    assert np.array_equal(np.asarray(jback.sigma), sig)
    assert jpv.dec_value(jpk, jsk, jback) == 143


def test_virtual_matches_eager_generation(keys, virtual_everything):
    """Materialized rows equal the eager generator's for the same (layer
    seed, idx, sign, salt) inputs."""
    jpk, jsk, pk, sk = keys
    vs = _product(pk, sk, 2, 3).sigma
    trip = vs.ltab[(vs.packed >> np.uint32(11)).astype(np.int64)]
    want = matrix.sigma_words(
        pk, trip[:, 0], trip[:, 1], trip[:, 2],
        ((vs.packed >> np.uint32(1)) & np.uint32(0x3FF)).astype(np.uint64),
        (vs.packed & np.uint32(1)).astype(np.uint64), vs.salt)
    assert np.array_equal(vs.materialize(), want)


def test_materialize_matches_jax_generator(keys, virtual_everything):
    """The port's rows against the JAX matrix.sigma_words_start for the same
    (ltab, packed, salt), materialized through a CPU engine and in a
    strided subset."""
    jpk, jsk, pk, sk = keys
    vs = _product(pk, sk, 4, 9).sigma
    trip = vs.ltab[(vs.packed >> np.uint32(11)).astype(np.int64)]
    want = np.asarray(jmatrix.sigma_words_start(
        jpk, trip[:, 0], trip[:, 1], trip[:, 2],
        ((vs.packed >> np.uint32(1)) & np.uint32(0x3FF)).astype(np.uint64),
        (vs.packed & np.uint32(1)).astype(np.uint64), vs.salt)())
    tpv.enable_device(pk, sk, "cpu")
    try:
        got = vs.materialize()
        rows = np.arange(0, len(vs), 7)
        sub = vs.materialize(rows)
    finally:
        tpv.disable_device(pk)
    assert np.array_equal(got, want)
    assert np.array_equal(sub, want[rows])


def test_density_sample_tracks_exact(keys, virtual_everything):
    jpk, jsk, pk, sk = keys
    prod = _product(pk, sk, 17, 19)
    assert isinstance(prod.sigma, VirtualSigma)
    exact = sigma_density(pk, prod)
    est = prod.sigma.density_sample(max_rows=64)  # strided subsample
    assert abs(est - exact) < 0.02


def test_recrypt_stays_virtual_without_materializing(keys, virtual_everything, monkeypatch):
    """recrypt.hpp:26-41 on a recipe-backed product: the balance check
    samples the density, the loop is skipped (fresh pseudorandom σ sits
    near 0.5) and the result keeps its virtual σ through compaction."""
    jpk, jsk, pk, sk = keys
    prod = _product(pk, sk, 21, 2)
    assert isinstance(prod.sigma, VirtualSigma)
    monkeypatch.setattr(rc, "VSIGMA_SAMPLE_MIN", 100)
    ek = rc.make_evalkey(pk, sk, 2, 1)
    out = rc.ct_recrypt(pk, ek, prod)
    assert isinstance(out.sigma, VirtualSigma)
    assert tpv.dec_value(pk, sk, out) == 42
