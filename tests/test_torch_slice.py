"""The port's slice end to end on the CPU: keygen, enc_value_batch, ct_add
and dec_value_batch, against the reference goldens and the JAX package.

Encryption draws from the OS CSPRNG, so it is checked by cross-decryption:
the port encrypts and the JAX package decrypts, and the reverse, with the
same keys carried over as numpy fields.  Decrypted values are exact
integers (tolerance 0)."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
import pvac_hfhe_cppbyv_tpu_torch as tpv

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


@pytest.mark.parametrize("which", ["small", "default"])
def test_goldens_decrypt(which):
    g = GOLDEN / which
    pk, sk = tpv.load_pklite(str(g / "pklite.bin"), device="cpu"), tpv.load_sk(str(g / "sk.bin"))
    exp = json.loads((g / "expected.json").read_text())
    names = ["a", "b", "sum", "diff", "zero", "scale1000", "prod", "recrypt_sum"]
    cts = [c for n in names for c in tpv.load_cts(str(g / f"{n}.ct"))]
    assert tpv.dec_value_batch(pk, sk, cts) == [exp[n] for n in names]
    assert [exp[n] for n in ("a", "b", "sum")] == [42, 17, 59]


def test_layer_R_matches_jax_on_product():
    """Layer blinding factors of a product ciphertext (BASE PRFs plus the
    PROD DAG) equal the JAX package's."""
    g = GOLDEN / "small"
    pk, sk = tpv.load_pklite(str(g / "pklite.bin"), device="cpu"), tpv.load_sk(str(g / "sk.bin"))
    jpk, jsk = jpv.load_pklite(str(g / "pklite.bin")), jpv.load_sk(str(g / "sk.bin"))
    (C,) = tpv.load_cts(str(g / "prod.ct"))
    (jC,) = jpv.load_cts(str(g / "prod.ct"))
    assert any(L.rule == tpv.RRULE_PROD for L in C.layers)
    assert tpv.layer_R(pk, sk, C) == jpv.layer_R(jpk, jsk, jC)


@pytest.mark.parametrize("which", ["small", "default"])
def test_ct_roundtrip_byte_exact(which, tmp_path):
    for name in ["a.ct", "sum.ct", "prod.ct"]:
        src = GOLDEN / which / name
        tpv.save_cts(tpv.load_cts(str(src)), str(tmp_path / name))
        assert (tmp_path / name).read_bytes() == src.read_bytes(), name


def test_key_files_roundtrip_and_H_digest(tmp_path):
    g = GOLDEN / "small"
    sk = tpv.load_sk(str(g / "sk.bin"))
    tpv.save_sk(sk, str(tmp_path / "sk.bin"))
    assert (tmp_path / "sk.bin").read_bytes() == (g / "sk.bin").read_bytes()
    pk = tpv.load_pklite(str(g / "pklite.bin"), with_H=True, device="cpu")
    tpv.save_pklite(pk, str(tmp_path / "pklite.bin"))
    assert (tmp_path / "pklite.bin").read_bytes() == (g / "pklite.bin").read_bytes()
    jpk = jpv.load_pklite(str(g / "pklite.bin"), with_H=True)
    assert np.array_equal(pk.H, jpk.H)
    assert np.array_equal(pk.ubk.perm, jpk.ubk.perm)
    bad = bytearray((g / "pklite.bin").read_bytes())
    bad[-(16 * pk.prm.B + 8 + 16 + 1)] ^= 1  # last byte of H_digest
    (tmp_path / "bad.bin").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="digest"):
        tpv.load_pklite(str(tmp_path / "bad.bin"), with_H=True, device="cpu")


def test_port_encrypts_jax_decrypts(keys, tmp_path):
    jpk, jsk, pk, sk = keys
    a, b = tpv.enc_value_batch(pk, sk, [42, 17])
    s = tpv.ct_add(pk, a, b)
    assert tpv.dec_value_batch(pk, sk, [a, b, s]) == [42, 17, 59]
    tpv.save_cts([a, b, s], str(tmp_path / "port.ct"))
    back = jpv.load_cts(str(tmp_path / "port.ct"))
    assert jpv.dec_value_batch(jpk, jsk, back) == [42, 17, 59]


def test_jax_encrypts_port_decrypts(keys, tmp_path):
    jpk, jsk, pk, sk = keys
    cts = jpv.enc_value_batch(jpk, jsk, [42, 17])
    jpv.save_cts(cts, str(tmp_path / "jax.ct"))
    a, b = tpv.load_cts(str(tmp_path / "jax.ct"))
    sums = tpv.ct_add_batch(pk, [(a, b), (b, b)])
    assert tpv.dec_value_batch(pk, sk, [a, b, *sums]) == [42, 17, 59, 34]
    assert tpv.dec_value_batch(pk, sk, [tpv.ct_sub(pk, a, b), tpv.ct_neg(pk, a)]) \
        == [25, P - 42]


def test_engine_on_cpu_with_small_chunks(keys):
    jpk, jsk, pk, sk = keys
    eng = tpv.enable_device(pk, sk, "cpu")
    try:
        eng.PRF_CHUNK, eng.SIGMA_CHUNK = 25, 30
        vals = [1, 2, 3, 1 << 63, P - 1]
        cts = tpv.enc_value_batch(pk, sk, vals, pipeline_chunk=2)
        assert tpv.dec_value_batch(pk, sk, cts) == vals
        assert eng.stats["prf_cores"] > 0 and eng.stats["sigma_edges"] > 0
    finally:
        tpv.disable_device(pk)


def test_enable_device_cuda_raises_without_card(keys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, pk, sk = keys
    with pytest.raises(RuntimeError):
        tpv.enable_device(pk, sk, "cuda")
    assert not hasattr(pk, "_engine")


def test_wide_ciphertext_sum_matches_jax(keys, tmp_path):
    """Thousands of maximal-weight edges of both signs: the port's 16-bit
    half-limb accumulation against the JAX uint64 one."""
    jpk, jsk, pk, sk = keys
    (a,) = tpv.enc_value_batch(pk, sk, [9])
    E = 3000
    rng = np.random.default_rng(8)
    w = np.tile(np.array([[0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF]],
                         dtype=np.uint32), (E, 1))
    w[::7] = rng.integers(0, 1 << 31, (len(w[::7]), 4)).astype(np.uint32)
    wide = tpv.Cipher(a.layers, rng.integers(0, 2, E), rng.integers(0, pk.prm.B, E),
                      (rng.random(E) < 0.3).astype(np.int8), w,
                      np.zeros((E, pk.prm.sigma_words32), dtype=np.uint32))
    tpv.save_cts([wide], str(tmp_path / "wide.ct"))
    want = jpv.dec_value_batch(jpk, jsk, jpv.load_cts(str(tmp_path / "wide.ct")))
    assert tpv.dec_value_batch(pk, sk, [wide]) == want


def test_port_keygen_slice():
    pk, sk = tpv.keygen(tpv.small_test_params(), device="cpu")
    assert pk.H.shape == (pk.prm.n_bits, pk.prm.sigma_words32)
    cts = tpv.enc_value_batch(pk, sk, [7, 8])
    s = tpv.ct_add_batch(pk, [(cts[0], cts[1])])
    assert tpv.dec_value_batch(pk, sk, cts + s) == [7, 8, 15]
