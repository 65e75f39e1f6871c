"""The degenerate-input tests of tests/test_edge_cases.py on the port (CPU
route, small Params).

Degenerate-input edge cases (empty ciphertexts, zero weights, bounds)."""
import numpy as np
import pytest

import pvac_hfhe_cppbyv_tpu_torch as pvac
from pvac_hfhe_cppbyv_tpu_torch.types import Cipher


@pytest.fixture(scope="module")
def small_keys():
    """A small-params key pair of the port, on the CPU."""
    return pvac.keygen(pvac.small_test_params(), device="cpu")


def _empty(mw=16):
    return Cipher(sigma_words=mw)


def test_empty_cipher_ops(small_keys):
    pk, sk = small_keys
    e = _empty(pk.prm.sigma_words32)
    assert pvac.dec_value(pk, sk, e) == 0
    s = pvac.ct_add(pk, e, e)
    assert s.n_edges == 0 and s.n_layers == 0
    m = pvac.ct_mul(pk, e, e)
    assert m.n_edges == 0
    assert pvac.dec_value(pk, sk, pvac.ct_scale(pk, e, 7)) == 0


def test_mul_by_enc_zero_gives_empty_sum(small_keys):
    pk, sk = small_keys
    a = pvac.enc_value(pk, sk, 5)
    z = pvac.enc_value(pk, sk, 0)
    m = pvac.ct_mul(pk, a, z)
    assert pvac.dec_value(pk, sk, m) == 0


def test_recrypt_empty_passthrough(small_keys):
    pk, sk = small_keys
    ek = pvac.make_evalkey(pk, sk, 1, 0)
    e = _empty(pk.prm.sigma_words32)
    out = pvac.ct_recrypt(pk, ek, e)
    assert out.n_edges == 0


def test_serialize_empty_cipher(tmp_path, small_keys):
    pk, sk = small_keys
    e = _empty(pk.prm.sigma_words32)
    a = pvac.enc_value(pk, sk, 3)
    pvac.save_cts([e, a], str(tmp_path / "x.ct"))
    back = pvac.load_cts(str(tmp_path / "x.ct"))
    assert back[0].n_edges == 0
    assert pvac.dec_value(pk, sk, back[1]) == 3


def test_enc_max_u64(small_keys):
    pk, sk = small_keys
    v = (1 << 64) - 1
    assert pvac.dec_value(pk, sk, pvac.enc_value(pk, sk, v)) == v


def test_sigma_density_empty(small_keys):
    pk, _ = small_keys
    assert pvac.sigma_density(pk, _empty(pk.prm.sigma_words32)) == 0.0
    assert pvac.sigma_shannon(_empty(pk.prm.sigma_words32)) == 0.0


def test_commit_empty(small_keys):
    pk, _ = small_keys
    c1 = pvac.commit_ct(pk, _empty(pk.prm.sigma_words32))
    assert len(c1) == 32


def test_layer_cycle_abort(small_keys):
    """decrypt.hpp:32-37 cycle abort parity."""
    from pvac_hfhe_cppbyv_tpu_torch.types import Layer, Nonce128, RSeed, RRULE_PROD

    pk, sk = small_keys
    C = _empty(pk.prm.sigma_words32)
    C.layers = [
        Layer(RRULE_PROD, RSeed(0, Nonce128(0, 0)), 1, 1),
        Layer(RRULE_PROD, RSeed(0, Nonce128(0, 0)), 0, 0),
    ]
    C.layer_id = np.array([0], dtype=np.int32)
    C.idx = np.array([1], dtype=np.int32)
    C.ch = np.array([0], dtype=np.int8)
    C.w = np.ones((1, 4), dtype=np.uint32)
    C.sigma = np.zeros((1, pk.prm.sigma_words32), dtype=np.uint32)
    with pytest.raises(ValueError, match="cycle"):
        pvac.dec_value(pk, sk, C)


def test_layer_out_of_range_abort(small_keys):
    from pvac_hfhe_cppbyv_tpu_torch.types import Layer, Nonce128, RSeed, RRULE_PROD

    pk, sk = small_keys
    C = _empty(pk.prm.sigma_words32)
    C.layers = [Layer(RRULE_PROD, RSeed(0, Nonce128(0, 0)), 0, 7)]
    C.layer_id = np.array([0], dtype=np.int32)
    C.idx = np.array([0], dtype=np.int32)
    C.ch = np.array([0], dtype=np.int8)
    C.w = np.ones((1, 4), dtype=np.uint32)
    C.sigma = np.zeros((1, pk.prm.sigma_words32), dtype=np.uint32)
    with pytest.raises(ValueError):
        pvac.dec_value(pk, sk, C)


def test_keygen_b_divides_check():
    """keygen.hpp:38-43 abort parity: B must divide p-1."""
    prm = pvac.small_test_params()
    prm.B = 338
    with pytest.raises(ValueError, match="B"):
        pvac.keygen(prm, device="cpu")
