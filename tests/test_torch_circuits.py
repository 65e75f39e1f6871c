"""The circuit tests of tests/test_circuits.py on the port's
models/circuits.py (CPU route, small Params): each circuit against its
plaintext mirror (reference shapes: examples/basic_usage.cpp sections on
polynomials, linear combos, fib/factorial, powers), plus the chains
cross-decrypted by the JAX package."""
import dataclasses
import math

import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
import pvac_hfhe_cppbyv_tpu_torch as pvac
from pvac_hfhe_cppbyv_tpu_torch.core import field as F
from pvac_hfhe_cppbyv_tpu_torch.models import circuits as C

torch.set_num_threads(2)

P = F.P


@pytest.fixture(scope="module")
def both():
    """A JAX key pair and the same keys in the port, on the CPU."""
    jpk, jsk = jpv.keygen(jpv.small_test_params())
    pkf = dict(prm=dataclasses.asdict(jpk.prm), canon_tag=jpk.canon_tag, H=jpk.H,
               ubk_perm=jpk.ubk.perm, ubk_inv=jpk.ubk.inv, H_digest=jpk.H_digest,
               omega_B=jpk.omega_B, powg_B=jpk.powg_B)
    return (jpk, jsk), pvac.keys_from_numpy(
        pkf, dict(prf_k=jsk.prf_k, lpn_s_bits=jsk.lpn_s_bits), device="cpu")


@pytest.fixture(scope="module")
def keys(both):
    return both[1]


def test_eval_polynomial(keys):
    pk, sk = keys
    coeffs = [7, 0, 3, 2]  # 7 + 3x^2 + 2x^3
    xv = 5
    x = pvac.enc_value(pk, sk, xv)
    out = C.eval_polynomial(pk, coeffs, x,
                            lambda v: pvac.enc_value(pk, sk, v))
    want = sum(c * xv ** i for i, c in enumerate(coeffs)) % P
    assert pvac.dec_value(pk, sk, out) == want


def test_linear_combination_and_matvec(keys):
    pk, sk = keys
    vals = [3, 1, 4, 1]
    cts = pvac.enc_value_batch(pk, sk, vals)
    ks = [10, 20, 30, 40]
    out = C.linear_combination(pk, cts, ks)
    assert pvac.dec_value(pk, sk, out) == \
        sum(v * k for v, k in zip(vals, ks)) % P
    rows = [[1, 2, 3, 4], [5, 0, 0, 1]]
    outs = C.matvec(pk, cts, rows)
    for row, o in zip(rows, outs):
        assert pvac.dec_value(pk, sk, o) == \
            sum(v * k for v, k in zip(vals, row)) % P


def test_chains(keys):
    pk, sk = keys
    assert pvac.dec_value(pk, sk, C.fibonacci_chain(pk, sk, 10)) == 55
    assert pvac.dec_value(pk, sk, C.factorial_chain(pk, sk, 7)) == \
        math.factorial(7)
    x = pvac.enc_value(pk, sk, 3)
    assert pvac.dec_value(pk, sk, C.power_chain(pk, x, 5)) == 3 ** 5 % P


def test_sum_chain_batched(keys):
    pk, sk = keys
    vals = list(range(1, 14))
    cts = pvac.enc_value_batch(pk, sk, vals)
    assert pvac.dec_value(pk, sk, C.sum_chain(pk, cts)) == sum(vals)


def test_dot_product(keys):
    pk, sk = keys
    xs_v = [2, 3, 5]
    ys_v = [7, 11, 13]
    xs = pvac.enc_value_batch(pk, sk, xs_v)
    ys = pvac.enc_value_batch(pk, sk, ys_v)
    out = C.dot_product(pk, xs, ys)
    assert pvac.dec_value(pk, sk, out) == \
        sum(a * b for a, b in zip(xs_v, ys_v)) % P


def test_mean_and_scaled_variance(keys):
    pk, sk = keys
    vals = [4, 8, 6, 2]
    n = len(vals)
    cts = pvac.enc_value_batch(pk, sk, vals)
    S, V = C.mean_and_scaled_variance(pk, cts)
    s = sum(vals)
    assert pvac.dec_value(pk, sk, S) == s % P
    want_v = (n * sum(v * v for v in vals) - s * s) % P
    assert pvac.dec_value(pk, sk, V) == want_v
    # sanity: n^2 * var relation on the plaintext side
    mean = s / n
    assert want_v == round(n * n * (sum((v - mean) ** 2 for v in vals) / n))


def _to_jax(cts, tmp_path):
    path = str(tmp_path / "c.ct")
    pvac.save_cts(cts, path)
    return jpv.load_cts(path)


def test_chains_decrypt_in_jax(both, tmp_path):
    """fibonacci_chain / factorial_chain of the port, decrypted by the JAX
    package."""
    (jpk, jsk), (pk, sk) = both
    cts = [C.fibonacci_chain(pk, sk, 20), C.factorial_chain(pk, sk, 12)]
    assert jpv.dec_value_batch(jpk, jsk, _to_jax(cts, tmp_path)) == \
        [6765, math.factorial(12)]
