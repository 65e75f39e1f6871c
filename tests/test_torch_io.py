"""The port's pk.bin and params.json I/O against the JAX package: the same
key saves to the same bytes at small and default Params, a pk.bin loads
field for field as the JAX loader reads it (the fields the format lacks
keep their Params defaults) and re-saves byte-exact.  Tolerance 0."""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
import pvac_hfhe_cppbyv_tpu_torch as tpv

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _carry(pk, sk):
    pkf = dict(prm=dataclasses.asdict(pk.prm), canon_tag=pk.canon_tag, H=pk.H,
               ubk_perm=pk.ubk.perm, ubk_inv=pk.ubk.inv, H_digest=pk.H_digest,
               omega_B=pk.omega_B, powg_B=pk.powg_B)
    return tpv.keys_from_numpy(pkf, dict(prf_k=sk.prf_k, lpn_s_bits=sk.lpn_s_bits), device="cpu")


@pytest.fixture(scope="module")
def small():
    jpk, jsk = jpv.keygen(jpv.small_test_params())
    return jpk, _carry(jpk, jsk)[0]


def _pk_fields(pk):
    return (dataclasses.asdict(pk.prm), pk.canon_tag, pk.H_digest, pk.omega_B, pk.powg_B)


def _same_pk(a, b):
    assert _pk_fields(a) == _pk_fields(b)
    assert a.H.dtype == b.H.dtype == np.uint32 and np.array_equal(a.H, b.H)
    assert np.array_equal(a.ubk.perm, b.ubk.perm) and np.array_equal(a.ubk.inv, b.ubk.inv)


def test_save_pk_same_bytes_small(small, tmp_path):
    jpk, tpk = small
    jpv.save_pk(jpk, str(tmp_path / "j.bin"))
    tpv.save_pk(tpk, str(tmp_path / "t.bin"))
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


def test_save_pk_same_bytes_default_golden(tmp_path):
    """Default Params: the golden pklite with H regenerated by each package."""
    g = str(GOLDEN / "default" / "pklite.bin")
    jpv.save_pk(jpv.load_pklite(g, with_H=True), str(tmp_path / "j.bin"))
    tpk = tpv.load_pklite(g, with_H=True, device="cpu")
    tpv.save_pk(tpk, str(tmp_path / "t.bin"))
    data = (tmp_path / "t.bin").read_bytes()
    assert data == (tmp_path / "j.bin").read_bytes()
    assert len(data) > tpk.prm.n_bits * tpk.prm.m_bits // 8


def test_load_pk_matches_jax(small, tmp_path):
    """Field for field as the JAX loader reads a JAX-written pk.bin; the
    fields the format lacks keep their defaults (n_bits 16384 beside an H
    of 1024 columns at small Params)."""
    jpk, _ = small
    path = str(tmp_path / "pk.bin")
    jpv.save_pk(jpk, path)
    got, want = tpv.load_pk(path, device="cpu"), jpv.load_pk(path)
    _same_pk(got, want)
    assert got.H.shape[0] == jpk.prm.n_bits == 1024
    default = tpv.Params()
    for k in ("n_bits", "h_col_wt", "x_col_wt", "err_wt", "recrypt_lo", "recrypt_hi",
              "recrypt_rounds"):
        assert getattr(got.prm, k) == getattr(default, k), k
    assert got.prm.m_bits == jpk.prm.m_bits and got.prm.lpn_n == jpk.prm.lpn_n


def test_load_pk_resaves_byte_exact(small, tmp_path):
    jpk, _ = small
    jpv.save_pk(jpk, str(tmp_path / "j.bin"))
    tpv.save_pk(tpv.load_pk(str(tmp_path / "j.bin"), device="cpu"), str(tmp_path / "t.bin"))
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


def test_load_pk_rejects_bad_files(small, tmp_path):
    jpk, _ = small
    path = tmp_path / "pk.bin"
    jpv.save_pk(jpk, str(path))
    data = bytearray(path.read_bytes())
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\0" * 8 + bytes(data[8:]))
    with pytest.raises(ValueError, match="bad PK"):
        tpv.load_pk(str(bad), device="cpu")
    # the second H record claims another nbits
    off = 8 + 6 * 4 + 2 * 4 + 8 + 4 + 8 + 32 + 8
    rec = 4 + 8 * ((jpk.prm.m_bits + 63) // 64)
    data[off + rec] ^= 0x40
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="unequal nbits"):
        tpv.load_pk(str(bad), device="cpu")


def test_save_pk_raises_without_H(tmp_path):
    pk = tpv.load_pklite(str(GOLDEN / "small" / "pklite.bin"), device="cpu")
    with pytest.raises(ValueError, match="with_H=True"):
        tpv.save_pk(pk, str(tmp_path / "pk.bin"))
    assert not (tmp_path / "pk.bin").exists()


@pytest.mark.parametrize("which", ["small", "default", "bounty2", "bounty3"])
def test_params_json_roundtrip_same_bytes(which, tmp_path):
    if which.startswith("bounty"):
        prm = jpv.load_params(str(GOLDEN / which / "params.json"))
    else:
        prm = jpv.small_test_params() if which == "small" else jpv.Params()
    jpv.save_params(prm, str(tmp_path / "j.json"))
    tprm = tpv.Params(**dataclasses.asdict(prm))
    tpv.save_params(tprm, str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert tpv.load_params(str(tmp_path / "j.json")) == tpv.params_from_json(
        (tmp_path / "j.json").read_text())
    assert dataclasses.asdict(tpv.load_params(str(tmp_path / "t.json"))) == \
        dataclasses.asdict(jpv.load_params(str(tmp_path / "j.json")))


def test_load_pk_cpu_attaches_no_engine(small, tmp_path):
    jpk, _ = small
    jpv.save_pk(jpk, str(tmp_path / "pk.bin"))
    assert not hasattr(tpv.load_pk(str(tmp_path / "pk.bin"), device="cpu"), "_engine")
