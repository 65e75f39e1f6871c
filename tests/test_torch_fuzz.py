"""The op-sequence fuzz tests of tests/test_fuzz.py on the port (CPU
route, small Params).

Randomized op-sequence fuzzing vs a plaintext mirror
(port of tests/test_ct_fuzz.cpp)."""
import random

import pytest

import pvac_hfhe_cppbyv_tpu_torch as pvac
from pvac_hfhe_cppbyv_tpu_torch.core import field as F


@pytest.fixture(scope="module")
def small_keys():
    """A small-params key pair of the port, on the CPU."""
    return pvac.keygen(pvac.small_test_params(), device="cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_op_chain(small_keys, seed):
    pk, sk = small_keys
    rng = random.Random(0xF00D + seed)
    val = rng.randrange(1000)
    ct = pvac.enc_value(pk, sk, val)
    muls = 0
    for _ in range(12):
        op = rng.randrange(4)
        k = rng.randrange(1, 50)
        if op == 0:
            ct = pvac.ct_add(pk, ct, pvac.enc_value(pk, sk, k))
            val = F.fp_add(val, k)
        elif op == 1:
            ct = pvac.ct_sub(pk, ct, pvac.enc_value(pk, sk, k))
            val = F.fp_sub(val, k)
        elif op == 2:
            ct = pvac.ct_scale(pk, ct, k)
            val = F.fp_mul(val, k)
        elif op == 3 and muls < 2:
            ct = pvac.ct_mul(pk, ct, pvac.enc_value(pk, sk, k))
            val = F.fp_mul(val, k)
            muls += 1
        assert ct.n_edges <= pk.prm.edge_budget
    assert pvac.dec_value(pk, sk, ct) == val


@pytest.mark.parametrize("seed", [11, 12])
def test_fuzz_batch_ops_mirror(small_keys, seed):
    """Plaintext-mirror chain mixing the BATCH add/sub APIs (round 4) with
    singles, mul, scale and recrypt — batch outputs (StackedSigma views)
    must compose identically through every downstream op."""
    pk, sk = small_keys
    rng = random.Random(0xBA7C + seed)
    vals = [rng.randrange(1000) for _ in range(6)]
    cts = pvac.enc_value_batch(pk, sk, vals)
    ek = pvac.make_evalkey(pk, sk, 2, 1)
    mirror = list(vals)
    muls = 0
    for _ in range(10):
        op = rng.randrange(6)
        i, j = rng.randrange(6), rng.randrange(6)
        if op == 0:
            outs = pvac.ct_add_batch(pk, [(cts[i], cts[j]), (cts[j], cts[i])])
            cts[i] = outs[0]
            mirror[i] = F.fp_add(mirror[i], mirror[j])
        elif op == 1:
            cts[i] = pvac.ct_sub_batch(pk, [(cts[i], cts[j])])[0]
            mirror[i] = F.fp_sub(mirror[i], mirror[j])
        elif op == 2:
            k = rng.randrange(1, 30)
            cts[i] = pvac.ct_scale(pk, cts[i], k)
            mirror[i] = F.fp_mul(mirror[i], k)
        elif op == 3 and muls < 2 and cts[i].n_edges * cts[j].n_edges < 1 << 21:
            cts[i] = pvac.ct_mul(pk, cts[i], cts[j])
            mirror[i] = F.fp_mul(mirror[i], mirror[j])
            muls += 1
        elif op == 4:
            cts[i] = pvac.ct_add(pk, cts[i], cts[j])
            mirror[i] = F.fp_add(mirror[i], mirror[j])
        elif op == 5 and cts[i].n_edges < 4096:
            cts[i] = pvac.ct_recrypt(pk, ek, cts[i])
    assert pvac.dec_value_batch(pk, sk, cts) == mirror
