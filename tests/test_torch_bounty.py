"""The bounty artifact tests (tests/test_bounty_artifacts.py) on the port:
the ORIGINAL shipped bounty artifacts through pvac_hfhe_cppbyv_tpu_torch.

These are the only cross-implementation fixtures the reference repo
publishes (bounty2_data/, bounty3_data/ — generated by tests/bounty2_test.cpp
and bounty3_test.cpp).  The public keys were never shipped for bounty2 and
the challenge sk never for bounty3, so full decryption is impossible by
design; these tests pin down byte-exact parsing, re-serialization, and the
documented structural facts (SURVEY.md §2.2, §6).
"""
import hashlib
import json
import pathlib

import numpy as np
import pytest

import pvac_hfhe_cppbyv_tpu_torch as pvac
from pvac_hfhe_cppbyv_tpu_torch.types import RRULE_BASE

B2 = pathlib.Path(__file__).parent / "golden" / "bounty2"
B3 = pathlib.Path(__file__).parent / "golden" / "bounty3"


def test_torch_bounty2_sha256_of_artifacts():
    # checksums published in bounty2_data/README.md
    assert hashlib.sha256((B2 / "a.ct").read_bytes()).hexdigest() == (
        "3bfb5f3415236435ed0e406fec30f934e1ce30574faaa0954ed794da0c6a96c4")
    assert hashlib.sha256((B2 / "b.ct").read_bytes()).hexdigest() == (
        "e94df1c8597ef34895e2175b7567f19ff081c7f517967fec0ee7bfef1a602ecb")
    assert hashlib.sha256((B2 / "params.json").read_bytes()).hexdigest() == (
        "692ea043daf5d8910a216a0cff80131fa6a06fe0133ac0f0b91a0f0570378877")


def test_torch_bounty2_params_roundtrip():
    prm = pvac.params_from_json((B2 / "params.json").read_text())
    assert prm.B == 337 and prm.m_bits == 8192 and prm.lpn_n == 4096
    # our writer reproduces the file byte-for-byte
    assert pvac.params_to_json(prm) == (B2 / "params.json").read_text()


@pytest.mark.parametrize("name,edges,layers", [
    ("a.ct", 40, 2), ("b.ct", 40, 2), ("sum.ct", 80, 4),
])
def test_torch_bounty2_ct_structure(name, edges, layers):
    cts = pvac.load_cts(str(B2 / name))
    assert len(cts) == 1
    C = cts[0]
    assert C.n_edges == edges and C.n_layers == layers
    assert all(L.rule == RRULE_BASE for L in C.layers)
    assert C.sigma.shape[1] == 8192 // 32
    # fresh enc σ density ~0.5 (SURVEY §6)
    from pvac_hfhe_cppbyv_tpu_torch.core import bitvec as BV

    dens = BV.popcnt(C.sigma).sum() / (C.n_edges * 8192)
    assert 0.49 < dens < 0.51


@pytest.mark.parametrize("name", ["a.ct", "b.ct", "sum.ct"])
def test_torch_bounty2_reserialize_byte_exact(name, tmp_path):
    cts = pvac.load_cts(str(B2 / name))
    pvac.save_cts(cts, str(tmp_path / name))
    assert (tmp_path / name).read_bytes() == (B2 / name).read_bytes()


def test_torch_bounty2_sum_is_concatenation():
    """sum.ct = combine_ciphers(a, b): layers concatenated with offset,
    edges concatenated."""
    a = pvac.load_cts(str(B2 / "a.ct"))[0]
    b = pvac.load_cts(str(B2 / "b.ct"))[0]
    s = pvac.load_cts(str(B2 / "sum.ct"))[0]
    for i, L in enumerate(a.layers + b.layers):
        assert s.layers[i].seed.ztag == L.seed.ztag
    assert np.array_equal(s.idx[:40], a.idx) and np.array_equal(s.idx[40:], b.idx)
    assert np.array_equal(s.w[:40], a.w) and np.array_equal(s.w[40:], b.w)
    assert np.array_equal(s.layer_id[40:], b.layer_id + 2)


def test_torch_bounty2_sk_loads():
    sk = pvac.load_sk(str(B2 / "sk.bin"))
    assert len(sk.prf_k) == 4
    assert len(sk.lpn_s_bits) == 64  # 4096 bits
    # our writer reproduces it byte-for-byte
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        pvac.save_sk(sk, d + "/sk.bin")
        assert open(d + "/sk.bin", "rb").read() == (B2 / "sk.bin").read_bytes()


def test_torch_bounty3_seed_ct_structure(tmp_path):
    assert hashlib.sha256((B3 / "seed.ct").read_bytes()).hexdigest() == (
        "304c5c9160fc374ecb42fba7641e21500cb729d031f9cbfb33c35a000229e474")
    cts = pvac.load_cts(str(B3 / "seed.ct"))
    # enc_text: [enc(len)] + one single-layer block cipher per 15 bytes
    assert len(cts) == 9
    assert cts[0].n_layers == 2  # enc_value 2-share split
    edge_counts = []
    for c in cts[1:]:
        assert c.n_layers == 1  # enc_fp_depth single layer
        assert c.sigma.shape[1] == 8192 // 32
        edge_counts.append(c.n_edges)
    # noise plan grows with the per-block depth hint (text.hpp:52-59)
    assert edge_counts == sorted(edge_counts)
    pvac.save_cts(cts, str(tmp_path / "seed.ct"))
    assert (tmp_path / "seed.ct").read_bytes() == (B3 / "seed.ct").read_bytes()
