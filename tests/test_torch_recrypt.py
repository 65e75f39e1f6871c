"""The port's recrypt, commit, text codec and metrics against the JAX
package, the reference goldens and the vectors.json known answers.

Recryption and encryption draw from the OS CSPRNG, so they are checked by
cross-decryption through both packages; commit, the metrics and the σ
bit permutation are deterministic and compared exactly (tolerance 0;
sigma_shannon is a float computed by the same numpy steps, compared
with ==)."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
import pvac_hfhe_cppbyv_tpu.utils.metrics as jmetrics
import pvac_hfhe_cppbyv_tpu_torch as tpv
import pvac_hfhe_cppbyv_tpu_torch.utils.metrics as metrics
from pvac_hfhe_cppbyv_tpu_torch.core import bitvec as BV
from pvac_hfhe_cppbyv_tpu_torch.core import fieldv as FV
from pvac_hfhe_cppbyv_tpu_torch.crypto import matrix
from pvac_hfhe_cppbyv_tpu_torch.params import Params
from pvac_hfhe_cppbyv_tpu_torch.types import (
    Cipher, Layer, Nonce128, PubKey, RSeed, RRULE_BASE, RRULE_PROD,
)

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
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


def _jax_dec(jpk, jsk, cts, path):
    tpv.save_cts(cts, str(path))
    return jpv.dec_value_batch(jpk, jsk, jpv.load_cts(str(path)))


def test_recrypt_roundtrips_cross_decrypt(keys, tmp_path):
    """ct_recrypt of a sum and of a product, with the port's evaluation
    key, decrypts through the port and through the JAX package."""
    jpk, jsk, pk, sk = keys
    ek = tpv.make_evalkey(pk, sk, 2, 1)
    assert tpv.dec_value(pk, sk, ek.enc_one) == 1
    assert tpv.dec_value_batch(pk, sk, ek.zero_pool) == [0, 0]
    a, b, c = (tpv.enc_value(pk, sk, v) for v in (777, 223, 2))
    outs = [tpv.ct_recrypt(pk, ek, tpv.ct_add(pk, a, b)),
            tpv.ct_recrypt(pk, ek, tpv.ct_mul(pk, a, c))]
    want = [1000, 1554]
    assert tpv.dec_value_batch(pk, sk, outs) == want
    assert _jax_dec(jpk, jsk, outs, tmp_path / "r.ct") == want


def test_ubk_apply_permutes_like_jax(keys):
    """ubk_apply on the same σ rows as the JAX package's."""
    jpk, jsk, pk, sk = keys
    (C,) = tpv.load_cts(str(GOLDEN / "small" / "sum.ct"))
    (J,) = jpv.load_cts(str(GOLDEN / "small" / "sum.ct"))
    tpv.ubk_apply(pk, C)
    jpv.ubk_apply(jpk, J)
    assert np.array_equal(C.sigma, np.asarray(J.sigma))


def test_commit_vector(vectors):
    """commit_ct against the reference KAT on a synthetic ciphertext, built
    as the JAX package's tests/test_scheme.py builds it."""
    pi = vectors["prf_inputs"]
    prm = Params()
    prm.m_bits = 512
    pk = PubKey(prm=prm, canon_tag=int(pi["canon_tag"]), H=None, ubk=None,
                H_digest=bytes.fromhex(pi["H_digest"]), omega_B=0, powg_B=[])
    layers = [Layer(RRULE_BASE, RSeed(11, Nonce128(22, 33))),
              Layer(RRULE_BASE, RSeed(44, Nonce128(55, 66))),
              Layer(RRULE_PROD, RSeed(0, Nonce128(0, 0)), 0, 1)]
    bv = np.zeros(16, dtype=np.uint32)
    bv[0], bv[1], bv[6] = 0x9ABCDEF0, 0x12345678, 7
    C = Cipher(layers, np.array([0, 2], dtype=np.int32), np.array([5, 300], dtype=np.int32),
               np.array([0, 1], dtype=np.int8),
               FV.to_u32(FV.from_ints([42, 123 | (456 << 64)])), np.stack([bv, bv]))
    assert tpv.commit_ct(pk, C).hex() == vectors["commit_ct"]


@pytest.mark.parametrize("which", ["small", "default"])
def test_commit_matches_jax_on_goldens(which):
    g = GOLDEN / which
    pk, jpk = tpv.load_pklite(str(g / "pklite.bin"), device="cpu"), jpv.load_pklite(str(g / "pklite.bin"))
    for name in ("a", "prod"):
        (C,) = tpv.load_cts(str(g / f"{name}.ct"))
        (J,) = jpv.load_cts(str(g / f"{name}.ct"))
        assert tpv.commit_ct(pk, C) == jpv.commit_ct(jpk, J)


@pytest.mark.parametrize("which", ["small", "default"])
def test_golden_text_and_recrypt_sum(which):
    g = GOLDEN / which
    pk, sk = tpv.load_pklite(str(g / "pklite.bin"), device="cpu"), tpv.load_sk(str(g / "sk.bin"))
    exp = json.loads((g / "expected.json").read_text())
    assert tpv.dec_text(pk, sk, tpv.load_cts(str(g / "text.ct"))) == exp["text"]
    assert tpv.dec_value_batch(pk, sk, tpv.load_cts(str(g / "recrypt_sum.ct"))) == \
        [exp["recrypt_sum"]]
    assert exp["text"] == "hello pvac on tpu!" and exp["recrypt_sum"] == 59


@pytest.mark.parametrize("msg", ["", "the quick brown fox jumps over 13 lazy dogs!",
                                 "fifteen bytes!!"])
def test_text_roundtrip_cross_decrypt(keys, msg, tmp_path):
    jpk, jsk, pk, sk = keys
    cts = tpv.enc_text(pk, sk, msg)
    assert len(cts) == 1 + -(-len(msg.encode()) // 15)
    assert tpv.dec_text(pk, sk, cts) == msg
    tpv.save_cts(cts, str(tmp_path / "t.ct"))
    assert jpv.dec_text(jpk, jsk, jpv.load_cts(str(tmp_path / "t.ct"))) == msg
    block = msg.encode()[:15]
    assert tpv.pack_15_bytes_to_fp(block) == jpv.pack_15_bytes_to_fp(block)
    assert tpv.unpack_fp_to_15_bytes(P - 1) == jpv.unpack_fp_to_15_bytes(P - 1)


def test_metrics_match_jax(keys, tmp_path):
    """sigma_shannon, the layer g-sums, check_mul_gsum_all and the
    dump_metrics CSV of the same ciphertexts equal the JAX package's."""
    jpk, jsk, pk, sk = keys
    a, b = tpv.enc_value_batch(pk, sk, [6, 7])
    prod = tpv.ct_mul(pk, a, b)
    bad = prod.copy()
    bad.w[0] = FV.to_u32(FV.add(FV.from_u32(bad.w[:1]), FV.from_ints([1])))[0]
    tpv.save_cts([a, b, prod, bad], str(tmp_path / "m.ct"))
    ja, jb, jprod, jbad = jpv.load_cts(str(tmp_path / "m.ct"))
    for C, J in ((a, ja), (prod, jprod)):
        assert tpv.sigma_shannon(C) == jpv.sigma_shannon(J)
        for lid in range(C.n_layers):
            assert tpv.agg_layer_gsum(pk, C, lid) == jpv.agg_layer_gsum(jpk, J, lid)
    assert tpv.check_mul_gsum_all(pk, a, b, prod) is True
    assert jpv.check_mul_gsum_all(jpk, ja, jb, jprod) is True
    assert tpv.check_mul_gsum_all(pk, a, b, bad) is False
    assert jpv.check_mul_gsum_all(jpk, ja, jb, jbad) is False
    outs = []
    for mod, p_, cs in ((metrics, pk, (a, prod)), (jmetrics, jpk, (ja, jprod))):
        path = tmp_path / f"{mod.__name__}.csv"
        mod._metrics_file = None
        try:
            mod.dump_metrics(p_, "t1", cs[0], 5, path=str(path))
            mod.dump_metrics(p_, "t2", cs[1], P - 1, path=str(path))
        finally:
            mod._metrics_file.close()
            mod._metrics_file = None
        outs.append(path.read_text())
    assert outs[0] == outs[1]
    assert outs[0].splitlines()[0] == "tag,edges,layers,sigma_density,value_lo,value_hi"


def test_apply_perm_sigma_vector(vectors):
    """σ of the sigma_small KAT, bit-permuted by ubk(canon_tag 0x777),
    against the reference's sigma_small_permuted."""
    s1 = BV.from_u64_words(np.array([int(x) for x in vectors["sigma_small"][0]],
                                    dtype=np.uint64))
    u = matrix.gen_ubk_public(0x777, 512)
    got = BV.to_u64_words(tpv.apply_perm_sigma(s1, u.inv))
    assert [int(x) for x in got] == [int(x) for x in vectors["sigma_small_permuted"]]
