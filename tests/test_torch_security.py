"""The security-regression tests of tests/test_security.py on the port
(CPU route, small Params).

Security-regression tests (ports of tests/test_zero.cpp,
test_struct.cpp, test_noise_struct.cpp, bounty_r2_attack.cpp)."""
import itertools

import numpy as np
import pytest

import pvac_hfhe_cppbyv_tpu_torch as pvac
from pvac_hfhe_cppbyv_tpu_torch.core import field as F
from pvac_hfhe_cppbyv_tpu_torch.core import fieldv as FV
from pvac_hfhe_cppbyv_tpu_torch.types import SGN_P


@pytest.fixture(scope="module")
def small_keys():
    """A small-params key pair of the port, on the CPU."""
    return pvac.keygen(pvac.small_test_params(), device="cpu")


def _edge_weights(C):
    # the port's fieldv takes torch limb tensors
    return FV.to_ints(FV.from_u32(C.w))


def _aggregator_sum(pk, C, lid=0):
    s = 0
    ws = _edge_weights(C)
    for e in range(C.n_edges):
        if int(C.layer_id[e]) != lid:
            continue
        term = F.fp_mul(ws[e], pk.powg_B[int(C.idx[e])])
        s = F.fp_add(s, term) if int(C.ch[e]) == SGN_P else F.fp_sub(s, term)
    return s


def test_zero_aggregator_nonzero(small_keys):
    """test_zero.cpp: layer-0 aggregate sum must never be zero (IND-CPA)."""
    pk, sk = small_keys
    for v in (0, 1, 2, 42, 100):
        c = pvac.enc_value(pk, sk, v)
        assert _aggregator_sum(pk, c, 0) != 0


def test_struct_no_8_subset_zero(small_keys):
    """test_struct.cpp 'regression #420': no 8-subset of layer-0 edge
    weights sums (signed) to zero."""
    pk, sk = small_keys
    c = pvac.enc_value(pk, sk, 123456789)
    ws = _edge_weights(c)
    e0 = [
        (ws[e], int(c.ch[e]))
        for e in range(c.n_edges)
        if int(c.layer_id[e]) == 0
    ]
    n = len(e0)
    if n < 8 or n > 30:
        pytest.skip("edge count out of range (reference skips too)")
    for comb in itertools.combinations(range(n), 8):
        acc = 0
        for t in comb:
            w, ch = e0[t]
            acc = F.fp_add(acc, w) if ch == SGN_P else F.fp_sub(acc, w)
        assert acc != 0


def test_noise_struct_no_z2_z3_visible(small_keys):
    """test_noise_struct.cpp: no same-layer pair/triple of signed
    w*g^idx terms sums to zero in a fresh ciphertext."""
    pk, sk = small_keys
    C = pvac.enc_value(pk, sk, 0xDEADBEEF)
    ws = _edge_weights(C)
    terms = []
    for e in range(C.n_edges):
        t = F.fp_mul(ws[e], pk.powg_B[int(C.idx[e])])
        if int(C.ch[e]) != SGN_P:
            t = F.fp_neg(t)
        terms.append((int(C.layer_id[e]), int(C.idx[e]), t))
    n = len(terms)
    for i in range(n):
        for j in range(i + 1, n):
            if terms[i][0] != terms[j][0] or terms[i][1] == terms[j][1]:
                continue
            assert F.fp_add(terms[i][2], terms[j][2]) != 0
    # z3: triples within one layer
    by_layer = {}
    for lid, idx, t in terms:
        by_layer.setdefault(lid, []).append(t)
    for lid, ts in by_layer.items():
        for a, b, c in itertools.combinations(ts, 3):
            assert F.fp_add(F.fp_add(a, b), c) != 0


def test_bounty_r2_no_edge_pair_reveals_R2(small_keys):
    """bounty_r2_attack.cpp: no ratio w_i/w_j across a fresh ct's two layers
    equals +-R^2-style invariants; concretely, no cross-layer pair of edges
    has equal weights or weights summing to zero."""
    pk, sk = small_keys
    C = pvac.enc_value(pk, sk, 7)
    ws = _edge_weights(C)
    lids = C.layer_id
    for i in range(C.n_edges):
        for j in range(i + 1, C.n_edges):
            if lids[i] == lids[j]:
                continue
            assert ws[i] != ws[j]
            assert F.fp_add(ws[i], ws[j]) != 0


def test_sk_bitflip_garbles_decrypt(small_keys):
    """bounty_test.cpp:339-348 fault-injection sanity: flipping ONE bit of
    the LPN secret must garble decryption (every R-core derives from the
    full secret through the PRF)."""
    import copy

    pk, sk = small_keys
    ct = pvac.enc_value(pk, sk, 31337)
    assert pvac.dec_value(pk, sk, ct) == 31337

    sk_bad = copy.deepcopy(sk)
    sk_bad.lpn_s_bits = list(sk.lpn_s_bits)
    sk_bad.lpn_s_bits[0] ^= 1 << 7  # flip LPN secret bit 7
    got = pvac.dec_value(pk, sk_bad, ct)
    assert got != 31337
