"""The plain reference against the port at small Params on the CPU: H's
digest, AES-256, the PRF cores and decryption of fresh ciphertexts and
products; and that it sees an altered weight."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench import cipher
from portbench.reference import scheme

pv = pytest.importorskip("pvac_hfhe_cppbyv_tpu_torch")


@pytest.fixture(scope="module")
def keys():
    prm = pv.small_test_params()
    pk, sk = pv.keygen(prm, device="cpu")
    key = scheme.Key(sk.prf_k, sk.lpn_s_bits, pk.canon_tag, pk.powg_B[1],
                     dataclasses.asdict(prm))
    return pk, sk, key


def test_aes256_fips197():
    k = torch.arange(32, dtype=torch.uint8)[None]
    pt = torch.tensor([int(c, 16) * 0x11 for c in "0123456789abcdef"], dtype=torch.uint8)
    ct = scheme.aes256_encrypt(scheme.expand_key(k), pt[None, None])
    assert bytes(ct.flatten().tolist()).hex() == "8ea2b7ca516745bfeafc49904b496089"


def test_h_digest(keys):
    pk, _, key = keys
    assert key.prefix[40:] == pk.H_digest


def test_cores_match_the_port(keys):
    pk, sk, key = keys
    seeds = [(int(a), int(b), int(c)) for a, b, c in
             np.random.default_rng(1).integers(0, 2**63, (5, 3), dtype=np.uint64)]
    from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn

    for dom in scheme.R_DOMS:
        want = [lpn.prf_R_core(pk, sk, pv.RSeed(z, pv.Nonce128(lo, hi)), dom)
                for z, lo, hi in seeds]
        assert key.cores(seeds, dom, "cpu") == want
    assert key.layer_values(seeds, "cpu") == [pv.prf_R(pk, sk, pv.RSeed(z, pv.Nonce128(lo, hi)))
                                             for z, lo, hi in seeds]


def test_walk_matches_the_vectorised_bits(keys):
    """The draw-by-draw path, taken only after a rejected noise draw, gives
    the same bits as the vectorised one where there is none."""
    pk, sk, key = keys
    seed = (123, 456, 789)
    dh = scheme.fnv1a(scheme.R_DOMS[0])
    k = torch.tensor(list(key._derive(seed, dh)), dtype=torch.uint8)[None]
    sw = key.s_words.shape[0]
    stream = scheme.ctr_stream(k, [dh ^ seed[1]], (127 * 8 * (sw + 1) + 15) // 16 + 2)
    y = key._walk(stream[0].numpy(), sw)
    ybits = pv.lpn_make_ybits(pk, sk, pv.RSeed(123, pv.Nonce128(456, 789)), scheme.R_DOMS[0],
                              127)
    assert y == (ybits[0] | ybits[1] << 64) & scheme.P


def test_decrypts_fresh_ciphertexts_and_products(keys):
    pk, sk, key = keys
    vals = [0, 1, 2**64 - 1, 77, 2**63 + 5]
    cts = pv.enc_value_batch(pk, sk, vals)
    assert scheme.decrypt_all(key, [cipher.record(c) for c in cts], "cpu") == vals
    prods = pv.ct_mul_batch(pk, [(cts[2], cts[4]), (cts[3], cts[3])])
    assert scheme.decrypt_all(key, [cipher.record(c) for c in prods], "cpu") == \
        [(2**64 - 1) * (2**63 + 5) % scheme.P, 77 * 77]


def test_sees_an_altered_weight(keys):
    pk, sk, key = keys
    rec = cipher.record(pv.enc_value_batch(pk, sk, [5])[0])
    rec["w"][0, 0] ^= 1
    assert scheme.decrypt_all(key, [rec], "cpu") != [5]


def test_rejects_a_wrong_generator(keys):
    pk, sk, _ = keys
    with pytest.raises(ValueError):
        scheme.Key(sk.prf_k, sk.lpn_s_bits, pk.canon_tag, 3, dataclasses.asdict(pk.prm))


def test_sigma_density(keys):
    pk, sk, _ = keys
    ct = pv.enc_value_batch(pk, sk, [9])[0]
    rows = cipher.sigma_rows(ct)
    m = pk.prm.m_bits
    assert cipher.density_dev([rows], m) < 0.15
    assert cipher.density_dev([np.zeros_like(rows)], m) == 0.5
