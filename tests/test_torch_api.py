"""The port's scalar reference API against the JAX package on the same
keys and inputs: prf_R, prf_R_noise, prf_noise_delta, prg_choose_k,
sigma_from_H, Shake256 / XofShake (also against hashlib) and sgn_val; and
the port exports every public name of the JAX package.  Tolerance 0."""
import dataclasses
import hashlib
import struct

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
import pvac_hfhe_cppbyv_tpu_torch as tpv

torch.set_num_threads(2)


def _carry(pk, sk):
    pkf = dict(prm=dataclasses.asdict(pk.prm), canon_tag=pk.canon_tag, H=pk.H,
               ubk_perm=pk.ubk.perm, ubk_inv=pk.ubk.inv, H_digest=pk.H_digest,
               omega_B=pk.omega_B, powg_B=pk.powg_B)
    return tpv.keys_from_numpy(pkf, dict(prf_k=sk.prf_k, lpn_s_bits=sk.lpn_s_bits), device="cpu")


@pytest.fixture(scope="module")
def keys():
    jpk, jsk = jpv.keygen(jpv.small_test_params())
    return jpk, jsk, *_carry(jpk, jsk)


def _seeds(n, seed):
    rows = np.random.default_rng(seed).integers(0, 1 << 64, (n, 3), dtype=np.uint64)
    return rows, [(int(z), int(lo), int(hi)) for z, lo, hi in rows]


def test_every_jax_export_is_in_the_port():
    assert set(jpv.__all__) <= set(tpv.__all__), sorted(set(jpv.__all__) - set(tpv.__all__))


@pytest.mark.parametrize("noise", [False, True])
def test_prf_R_matches_jax(keys, noise):
    jpk, jsk, tpk, tsk = keys
    rows, seeds = _seeds(8, 60 + noise)
    jf, tf = (jpv.prf_R_noise, tpv.prf_R_noise) if noise else (jpv.prf_R, tpv.prf_R)
    got = [tf(tpk, tsk, tpv.RSeed(z, tpv.Nonce128(lo, hi))) for z, lo, hi in seeds]
    want = [jf(jpk, jsk, jpv.RSeed(z, jpv.Nonce128(lo, hi))) for z, lo, hi in seeds]
    assert got == want and all(0 < v < tpv.P for v in got)
    assert tpv.fieldv.to_ints(tpv.prf_R_batch(tpk, tsk, rows, noise=noise)) == got


def test_prf_noise_delta_matches_jax(keys):
    jpk, jsk, tpk, tsk = keys
    _, seeds = _seeds(8, 62)
    for i, (z, lo, hi) in enumerate(seeds):
        g, kind = i * 3, i % 2
        got = tpv.prf_noise_delta(tpk, tsk, tpv.RSeed(z, tpv.Nonce128(lo, hi)), g, kind)
        want = jpv.prf_noise_delta(jpk, jsk, jpv.RSeed(z, jpv.Nonce128(lo, hi)), g, kind)
        assert got == want


@pytest.mark.parametrize("k,N,label", [(32, 1024, "pvac.dom.x_seed"), (48, 512, "pvac.dom.h_gen"),
                                       (7, 7, "UBK"), (5, 1, "L")])
def test_prg_choose_k_matches_jax(k, N, label):
    words = [1, 2 ** 64 - 1, 12345, 0, 77]
    got = tpv.prg_choose_k(min(k, N), N, label, words)
    assert got == jpv.prg_choose_k(min(k, N), N, label, words)
    assert len(set(got)) == len(got) == min(k, N) and all(0 <= x < N for x in got)


def test_sigma_from_H_matches_jax(keys):
    jpk, _, tpk, _ = keys
    rng = np.random.default_rng(63)
    for _ in range(8):
        z, lo, hi, salt = (int(x) for x in rng.integers(0, 1 << 64, 4, dtype=np.uint64))
        idx, ch = int(rng.integers(0, tpk.prm.B)), int(rng.integers(0, 2))
        got = tpv.sigma_from_H(tpk, z, tpv.Nonce128(lo, hi), idx, ch, salt)
        want = jpv.sigma_from_H(jpk, z, jpv.Nonce128(lo, hi), idx, ch, salt)
        assert got.dtype == np.uint32 and got.shape == (tpk.prm.sigma_words32,)
        assert np.array_equal(got, np.asarray(want))


def _shake(mod, data: bytes, n_out: int) -> bytes:
    s = mod.Shake256()
    s.absorb(data)
    return s.squeeze(n_out)


@pytest.mark.parametrize("n_in,n_out", [(0, 32), (3, 8), (135, 136), (137, 137), (300, 500)])
def test_shake256_matches_jax_and_hashlib(n_in, n_out):
    data = bytes(np.random.default_rng(n_in).integers(0, 256, n_in, dtype=np.uint8))
    assert _shake(tpv, data, n_out) == _shake(jpv, data, n_out) == \
        hashlib.shake_256(data).digest(n_out)


@pytest.mark.parametrize("n_in", [136, 272])
def test_shake256_whole_blocks_follow_fips202(n_in):
    """An input of a whole number of 136-byte blocks: the port hashes it as
    hashlib does; the JAX copy pads before permuting the last block."""
    data = bytes(np.random.default_rng(n_in).integers(0, 256, n_in, dtype=np.uint8))
    want = hashlib.shake_256(data).digest(64)
    assert _shake(tpv, data, 64) == want != _shake(jpv, data, 64)


def test_xof_shake_reference_vectors(vectors):
    v = vectors["xof_shake"]
    x = tpv.XofShake(v["label"], [int(s) for s in v["seed"]])
    assert [x.take_u64() for _ in v["u64s"]] == [int(w) for w in v["u64s"]]
    assert [x.bounded(337) for _ in v["bounded337"]] == [int(w) for w in v["bounded337"]]


def test_xof_shake_matches_jax_and_hashlib():
    seeds = [7, 2 ** 64 - 1, 0]
    t, j = tpv.XofShake("pvac.xof", seeds), jpv.XofShake("pvac.xof", seeds)
    assert [t.take_u64() for _ in range(20)] == [j.take_u64() for _ in range(20)]
    assert [t.bounded(m) for m in (1, 2, 337, 1 << 40)] == \
        [j.bounded(m) for m in (1, 2, 337, 1 << 40)]
    fresh = tpv.XofShake("pvac.xof", seeds)
    stream = hashlib.shake_256(b"pvac.xof" + struct.pack("<3Q", *seeds)).digest(8 * 20)
    assert [fresh.take_u64() for _ in range(20)] == list(struct.unpack("<20Q", stream))


def test_sgn_val():
    assert tpv.sgn_val(tpv.SGN_P) == jpv.sgn_val(jpv.SGN_P) == 1
    assert tpv.sgn_val(tpv.SGN_M) == jpv.sgn_val(jpv.SGN_M) == -1
