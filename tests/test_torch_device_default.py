"""The port's entry points run on the card unless the caller asks for the
CPU: keygen, load_pklite, load_pk, keys_from_numpy and Client.generate
attach a CUDA engine by
default and raise, naming the device, where there is no card; with
device="cpu" they attach none; an engine attached without the secret key
binds the sk an operation passes and runs the PRF through the device
route, with cores equal to host-keyed ones.  Whether a card is present is
decided inside each test."""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "small"


@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    jpk, jsk = jpv.keygen(jpv.small_test_params())
    pkf = dict(prm=dataclasses.asdict(jpk.prm), canon_tag=jpk.canon_tag, H=jpk.H,
               ubk_perm=jpk.ubk.perm, ubk_inv=jpk.ubk.inv, H_digest=jpk.H_digest,
               omega_B=jpk.omega_B, powg_B=jpk.powg_B)
    pk_bin = tmp_path_factory.mktemp("pk") / "pk.bin"
    jpv.save_pk(jpk, str(pk_bin))
    return pkf, dict(prf_k=jsk.prf_k, lpn_s_bits=jsk.lpn_s_bits), str(pk_bin)


def _entry(name, fields, **kw):
    """Call one entry point; returns the public key it made."""
    if name == "keygen":
        return tpv.keygen(tpv.small_test_params(), **kw)[0]
    if name == "load_pklite":
        return tpv.load_pklite(str(GOLDEN / "pklite.bin"), **kw)
    if name == "load_pk":
        return tpv.load_pk(fields[2], **kw)
    if name == "Client.generate":
        return tpv.Client.generate(tpv.small_test_params(), **kw).pk
    return tpv.keys_from_numpy(*fields[:2], **kw)[0]


ENTRIES = ["keygen", "load_pklite", "keys_from_numpy", "load_pk", "Client.generate"]


@pytest.mark.parametrize("name", ENTRIES)
def test_default_device_is_the_card(name, fields):
    if torch.cuda.is_available():
        pk = _entry(name, fields)
        assert pk._engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cuda'"):
            _entry(name, fields)


@pytest.mark.parametrize("name", ENTRIES)
def test_cpu_device_attaches_no_engine(name, fields):
    pk = _entry(name, fields, device="cpu")
    assert not hasattr(pk, "_engine")


def test_engine_without_sk_binds_it(fields):
    """A CPU engine attached to the public key alone binds the sk the
    first enc_value_batch passes; its PRF cores equal host-keyed ones,
    and a different sk rebinds."""
    pk, sk = tpv.keys_from_numpy(*fields[:2], device="cpu")
    host_pk, _ = tpv.keys_from_numpy(*fields[:2], device="cpu")
    eng = tpv.enable_device(pk, None, "cpu")
    assert eng.s32_dev is None and eng.sk is None
    cts = tpv.enc_value_batch(pk, sk, [3, 1 << 40])
    assert eng.sk is sk and eng.s32_dev is not None and eng.stats["prf_cores"] > 0
    assert tpv.dec_value_batch(pk, sk, cts) == [3, 1 << 40]
    rng = np.random.default_rng(4)
    seeds = rng.integers(0, 1 << 64, (12, 3), dtype=np.uint64)
    dh = np.array([lpn.DOM_HASH[tpv.Dom.PRF_R2]] * 12, dtype=np.uint64)
    n0 = eng.stats["prf_cores"]
    assert np.array_equal(lpn.prf_cores_batch(pk, sk, seeds, dh),
                          lpn.prf_cores_batch(host_pk, sk, seeds, dh))
    assert eng.stats["prf_cores"] == n0 + 12
    other = tpv.SecKey(prf_k=[k ^ 1 for k in sk.prf_k], lpn_s_bits=list(sk.lpn_s_bits))
    assert np.array_equal(lpn.prf_cores_batch(pk, other, seeds, dh),
                          lpn.prf_cores_batch(host_pk, other, seeds, dh))
    assert eng.sk is other


def test_sigma_without_H_raises_on_engine():
    pk = tpv.load_pklite(str(GOLDEN / "pklite.bin"), device="cpu")
    tpv.enable_device(pk, None, "cpu")
    z = np.zeros(1, dtype=np.uint64)
    with pytest.raises(ValueError, match="with_H"):
        from pvac_hfhe_cppbyv_tpu_torch.crypto import matrix
        matrix.sigma_words(pk, z, z, z, z, z, z)
