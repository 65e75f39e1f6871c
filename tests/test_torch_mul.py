"""ct_mul, ct_sub_batch, ct_scale and ct_div_const of the port against the
JAX package.

A product draws fresh PROD layer nonces and σ salts from the OS CSPRNG,
so products are compared three ways: the staged edge columns of the
cross-product aggregation for the same inputs, cross-decryption in both
directions, and σ rows against the JAX σ generator for the same stream
words.  Everything is exact (tolerance 0: integer columns, field limbs,
σ bits and decrypted values)."""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
from pvac_hfhe_cppbyv_tpu.crypto import matrix as jmatrix
from pvac_hfhe_cppbyv_tpu.ops import arithmetic as jarith
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch import native as tnative
from pvac_hfhe_cppbyv_tpu_torch.ops import arithmetic as arith
from pvac_hfhe_cppbyv_tpu_torch.types import LazySigma

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


def _golden(which, names):
    g = GOLDEN / which
    port = [c for n in names for c in tpv.load_cts(str(g / f"{n}.ct"))]
    jax = [c for n in names for c in jpv.load_cts(str(g / f"{n}.ct"))]
    return port, jax


def _columns(C):
    return (C.layer_id, C.idx, C.ch, np.asarray(C.w, dtype=np.uint32))


def _same_ct(C, J):
    assert [(L.rule, L.pa, L.pb, L.seed.ztag, L.seed.nonce.lo, L.seed.nonce.hi)
            for L in C.layers] == \
        [(L.rule, L.pa, L.pb, L.seed.ztag, L.seed.nonce.lo, L.seed.nonce.hi)
         for L in J.layers]
    for a, b in zip(_columns(C), _columns(J)):
        assert np.array_equal(a, b)
    assert np.array_equal(np.asarray(C.sigma), np.asarray(J.sigma))


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("pair", [("a", "b"), ("prod", "a"), ("diff", "prod")])
def test_staged_columns_match_jax(pair, route, monkeypatch):
    """The port's cross-product aggregation (native, and its numpy
    fallback) against the JAX package's native one, on fresh and product
    inputs."""
    pk = tpv.load_pklite(str(GOLDEN / "small" / "pklite.bin"), device="cpu")
    (A, B), (jA, jB) = _golden("small", pair)
    if route == "numpy":
        monkeypatch.setattr(tnative, "mul_cross_agg", lambda *a: None)
    base = A.n_layers + B.n_layers
    got = arith._ct_mul_stage_host(pk, [], base, A, B)
    want = jarith._ct_mul_stage_host(pk, [], base, jA, jB)
    assert len(want["out_lid"]) > 0
    for k in ("out_lid", "out_idx", "out_ch", "out_w"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_port_mul_of_default_goldens_decrypts_in_both(tmp_path):
    """Golden a (42) x b (17) at default Params: the port's product
    decrypts to 714 through the port and through the JAX package."""
    g = GOLDEN / "default"
    pk = tpv.load_pklite(str(g / "pklite.bin"), with_H=True, device="cpu")
    sk = tpv.load_sk(str(g / "sk.bin"))
    a, b = (tpv.load_cts(str(g / f"{n}.ct"))[0] for n in ("a", "b"))
    C = tpv.ct_mul(pk, a, b)
    assert C.n_layers == 8 and C.n_edges > 1000
    assert tpv.dec_value_batch(pk, sk, [C]) == [714]
    tpv.save_cts([C], str(tmp_path / "prod.ct"))
    jpk, jsk = jpv.load_pklite(str(g / "pklite.bin")), jpv.load_sk(str(g / "sk.bin"))
    assert jpv.dec_value_batch(jpk, jsk, jpv.load_cts(str(tmp_path / "prod.ct"))) == [714]


def test_jax_mul_decrypts_through_port(keys, tmp_path):
    jpk, jsk, pk, sk = keys
    a, b = jpv.enc_value_batch(jpk, jsk, [6, 7])
    jpv.save_cts(jarith.ct_mul_batch(jpk, [(a, b), (b, b)]), str(tmp_path / "jax.ct"))
    assert tpv.dec_value_batch(pk, sk, tpv.load_cts(str(tmp_path / "jax.ct"))) == [42, 49]


def test_product_sigma_rows_match_jax(keys, monkeypatch):
    """σ rows of a port product equal the JAX σ generator's for the same
    stream words (layer seed, idx, sign and salt of each edge)."""
    jpk, jsk, pk, sk = keys
    salts = np.random.default_rng(12).integers(0, 1 << 64, 4096, dtype=np.uint64)
    monkeypatch.setattr(arith, "csprng_u64_array", lambda n: salts[:n].copy())
    a, b = tpv.enc_value_batch(pk, sk, [3, 5])
    C = tpv.ct_mul(pk, a, b)
    seeds = np.array([[L.seed.ztag, L.seed.nonce.lo, L.seed.nonce.hi]
                      for L in C.layers], dtype=np.uint64)[C.layer_id]
    want = jmatrix.sigma_words(
        jpk, seeds[:, 0], seeds[:, 1], seeds[:, 2], C.idx.astype(np.uint64),
        C.ch.astype(np.uint64), salts[: C.n_edges])
    assert np.array_equal(np.asarray(C.sigma), want)
    assert tpv.dec_value_batch(pk, sk, [C]) == [15]


def test_sub_scale_div_match_jax():
    """Host σ (loaded goldens, the batched route): same layers, columns and
    σ as the JAX package."""
    pk = tpv.load_pklite(str(GOLDEN / "small" / "pklite.bin"), device="cpu")
    jpk = jpv.load_pklite(str(GOLDEN / "small" / "pklite.bin"))
    sk = tpv.load_sk(str(GOLDEN / "small" / "sk.bin"))
    (a, b, prod), (ja, jb, jprod) = _golden("small", ["a", "b", "prod"])
    pairs = [(a, b), (b, a), (prod, a), (a, prod)]
    jpairs = [(ja, jb), (jb, ja), (jprod, ja), (ja, jprod)]
    subs = tpv.ct_sub_batch(pk, pairs)
    for C, J in zip(subs, jarith.ct_sub_batch(jpk, jpairs)):
        _same_ct(C, J)
    scaled = [tpv.ct_scale(pk, a, 1000), tpv.ct_scale(pk, prod, P - 3),
              tpv.ct_div_const(pk, a, 7)]
    jscaled = [jarith.ct_scale(jpk, ja, 1000), jarith.ct_scale(jpk, jprod, P - 3),
               jarith.ct_div_const(jpk, ja, 7)]
    for C, J in zip(scaled, jscaled):
        _same_ct(C, J)
    inv7 = pow(7, P - 2, P)
    assert tpv.dec_value_batch(pk, sk, subs + scaled) == [
        25, P - 25, 714 - 42, 42 - 714 + P, 42000, (P - 3) * 714 % P, 42 * inv7 % P]


def test_mul_batch_then_sub_on_engine(keys, monkeypatch, tmp_path):
    """ct_mul_batch through a CPU engine with σ pooled across products in
    small dispatches (a remainder included), then ct_sub_batch of the
    products (σ on the device: the pair-by-pair route); decrypts exactly
    through the port and the JAX package."""
    jpk, jsk, pk, sk = keys
    monkeypatch.setattr(arith, "SIGMA_DISPATCH", 500)
    vals = [3, 1 << 40, P - 2, 11, 0, 9]
    cts = tpv.enc_value_batch(pk, sk, vals)
    eng = tpv.enable_device(pk, sk, "cpu")
    try:
        prods = tpv.ct_mul_batch(pk, [(cts[0], cts[1]), (cts[2], cts[3]), (cts[4], cts[5])])
        subs = tpv.ct_sub_batch(pk, [(prods[0], prods[1]), (prods[1], prods[2])])
        assert eng.stats["sigma_edges"] == sum(C.n_edges for C in prods)
        got = tpv.dec_value_batch(pk, sk, prods + subs)
    finally:
        tpv.disable_device(pk)
    p = [3 << 40, (P - 2) * 11 % P, 0]
    assert got == p + [(p[0] - p[1]) % P, (p[1] - p[2]) % P]
    assert isinstance(subs[0].sigma, LazySigma)
    tpv.save_cts(prods + subs, str(tmp_path / "port.ct"))
    assert jpv.dec_value_batch(jpk, jsk, jpv.load_cts(str(tmp_path / "port.ct"))) == got


def test_unported_routes_raise(keys, monkeypatch):
    """The routes that raised NotImplementedError before the grid and
    VirtualSigma were ported now run: a product the native aggregator
    cannot take goes to the engine's dense grid, and a product past
    SIGMA_EAGER_MAX keeps a VirtualSigma.  A grid that fails raises: it
    never falls back to the host."""
    jpk, jsk, pk, sk = keys
    a, b = tpv.enc_value_batch(pk, sk, [2, 3])
    monkeypatch.setattr(arith, "MULGRID_PAIR_THRESHOLD", 16)
    monkeypatch.setattr(arith, "NATIVE_AGG_PAIR_MAX", 8)
    assert tpv.dec_value_batch(pk, sk, [tpv.ct_mul(pk, a, b)]) == [6]  # no engine
    eng = tpv.enable_device(pk, sk, "cpu")
    try:
        assert tpv.dec_value_batch(pk, sk, [tpv.ct_mul(pk, a, b)]) == [6]
        assert eng.stats["mulgrid_blocks"] == 1

        def broken(*args):
            raise RuntimeError("grid failed")

        monkeypatch.setattr(eng.mulgrid, "start", broken)
        with pytest.raises(RuntimeError, match="grid failed"):
            tpv.ct_mul(pk, a, b)
    finally:
        tpv.disable_device(pk)
    monkeypatch.setattr(arith, "SIGMA_EAGER_MAX", 20)
    C = tpv.ct_mul(pk, a, b)
    assert isinstance(C.sigma, tpv.VirtualSigma)
    assert tpv.dec_value_batch(pk, sk, [C]) == [6]
