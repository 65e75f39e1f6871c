"""Kernel D's plain twin (SHA-256 of pre-padded messages) and PRF key
derivation on a device, against hashlib, the JAX package's numpy
derive_keys_xp, the reference's derive_aes_key vectors, and host-derived
PRF cores.  Bit-exact (tolerance 0: integer digests, keys and field
values)."""
import dataclasses
import hashlib
import pathlib

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
from pvac_hfhe_cppbyv_tpu.crypto import lpn as jlpn
from pvac_hfhe_cppbyv_tpu.params import Params as JParams
from pvac_hfhe_cppbyv_tpu.types import PubKey as JPubKey, SecKey as JSecKey
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.core import hash as H
from pvac_hfhe_cppbyv_tpu_torch.core.bits import u32_to_i32
from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn, sha256_blocks as sb

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _fields(u64: np.ndarray) -> torch.Tensor:
    """[n, k] uint64 -> [n, k, 2] int64 (lo, hi) u32 halves."""
    u64 = np.ascontiguousarray(u64, dtype=np.uint64)
    return torch.from_numpy(u64.view(np.uint32).reshape(*u64.shape, 2).astype(np.int64))


def _digest_bytes(d: torch.Tensor) -> list[bytes]:
    """[n, 8] int32 digest words -> digest bytes BE(h0)..BE(h7)."""
    return [d[i].numpy().view(np.uint32).astype(">u4").tobytes() for i in range(d.shape[0])]


@pytest.mark.parametrize("prefix_len,n_fields", [(3, 2), (40, 1), (72, 4), (100, 3)])
def test_plain_matches_hashlib(prefix_len, n_fields):
    """1-block (3 + 16, 40 + 8 bytes) and 2-block (72 + 32, 100 + 24 bytes)
    messages, padded by MsgLayout."""
    rng = np.random.default_rng(prefix_len)
    prefix = bytes(rng.integers(0, 256, prefix_len, dtype=np.uint8))
    layout = H.MsgLayout(prefix, n_fields)
    u64 = rng.integers(0, 1 << 64, (9, n_fields), dtype=np.uint64)
    blocks = u32_to_i32(layout.build_blocks(_fields(u64)))
    assert blocks.shape == (9, layout.n_blocks, 16)
    got = _digest_bytes(sb.sha256_blocks_plain(blocks))
    want = [hashlib.sha256(prefix + row.astype("<u8").tobytes()).digest() for row in u64]
    assert got == want


def test_dispatch_uses_twin_on_cpu():
    blocks = torch.zeros((2, 1, 16), dtype=torch.int32)
    assert torch.equal(sb.sha256_blocks(blocks), sb.sha256_blocks_plain(blocks))
    with pytest.raises(ValueError):
        sb.sha256_blocks_cuda(blocks)


@pytest.fixture(scope="module")
def synth(vectors):
    """The reference's synthetic PRF key set, in both packages."""
    pi = vectors["prf_inputs"]
    prf_k = [int(x) for x in pi["prf_k"]]
    bits = [int(x) for x in pi["lpn_s_bits"]]
    kw = dict(canon_tag=int(pi["canon_tag"]), H=None, ubk=None,
              H_digest=bytes.fromhex(pi["H_digest"]), omega_B=0, powg_B=[])
    jpk = JPubKey(prm=JParams(), **kw)
    pk = tpv.PubKey(prm=tpv.Params(), **kw)
    seed = [int(pi["ztag"]), int(pi["nonce_lo"]), int(pi["nonce_hi"])]
    return jpk, JSecKey(prf_k=prf_k, lpn_s_bits=bits), pk, \
        tpv.SecKey(prf_k=prf_k, lpn_s_bits=bits), seed


def test_derive_keys_device_matches_jax_xp(synth):
    jpk, jsk, pk, sk, _ = synth
    rng = np.random.default_rng(23)
    f64 = rng.integers(0, 1 << 64, (16, 4), dtype=np.uint64)
    f64[0] = (1 << 64) - 1
    jl = jlpn.derive_layout(jpk, jsk)
    want = jlpn.derive_keys_xp(jl, jl.template_words(),
                               f64.view(np.uint32).reshape(16, 4, 2))
    layout = lpn.derive_layout(pk, sk)
    assert layout.n_blocks == jl.n_blocks == 2
    got = lpn.derive_keys_device(layout, layout.template_tensor(), _fields(f64))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_derive_keys_device_matches_vectors(vectors, synth):
    """The reference's derive_aes_key KATs (key bytes), one per domain."""
    _, _, pk, sk, seed = synth
    cases = vectors["derive_aes_key"]
    f64 = np.array([seed + [lpn.fnv1a_domain(c["dom"])] for c in cases], dtype=np.uint64)
    layout = lpn.derive_layout(pk, sk)
    got = lpn.derive_keys_device(layout, layout.template_tensor(), _fields(f64))
    assert [bytes(k).hex() for k in got.numpy()] == [c["key"] for c in cases]


@pytest.mark.parametrize("params", ["small", "default"])
def test_device_derived_cores_match_host(params):
    """prf_R cores through a CPU engine (keys derived from the seeds by the
    twins of kernels D and E) equal the host-keyed cores of the JAX package
    and of the port without an engine.  Default Params: a handful of
    full-size cores."""
    if params == "small":
        jpk, jsk = jpv.keygen(jpv.small_test_params())
        pkf = dict(prm=dataclasses.asdict(jpk.prm), canon_tag=jpk.canon_tag, H=jpk.H,
                   ubk_perm=None, ubk_inv=None, H_digest=jpk.H_digest,
                   omega_B=jpk.omega_B, powg_B=jpk.powg_B)
        pk, sk = tpv.keys_from_numpy(pkf, dict(prf_k=jsk.prf_k, lpn_s_bits=jsk.lpn_s_bits), device="cpu")
        n = 40
    else:
        g = GOLDEN / "default"
        jpk, jsk = jpv.load_pklite(str(g / "pklite.bin")), jpv.load_sk(str(g / "sk.bin"))
        pk, sk = tpv.load_pklite(str(g / "pklite.bin"), device="cpu"), tpv.load_sk(str(g / "sk.bin"))
        n = 4
    rng = np.random.default_rng(5)
    seeds = rng.integers(0, 1 << 64, (n, 3), dtype=np.uint64)
    doms = [jlpn.DOM_HASH[d] for d in ("pvac.prf.r.1", "pvac.prf.r.3", "pvac.prf.noise.2")]
    dh = np.array(doms, dtype=np.uint64)[np.arange(n) % 3]
    host = lpn.prf_cores_batch(pk, sk, seeds, dh)
    eng = tpv.enable_device(pk, sk, "cpu")
    try:
        eng.PRF_CHUNK = 3 if params == "small" else 16384
        dev = lpn.prf_cores_batch(pk, sk, seeds, dh)
        assert eng.stats["prf_cores"] == n
    finally:
        tpv.disable_device(pk)
    assert np.array_equal(dev, host)
    assert np.array_equal(dev, jlpn.prf_cores_batch(jpk, jsk, seeds, dh))


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(synth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, pk, sk, _ = synth
    rng = np.random.default_rng(9)
    f64 = rng.integers(0, 1 << 64, (4096, 4), dtype=np.uint64)
    layout = lpn.derive_layout(pk, sk)
    blocks = u32_to_i32(layout.build_blocks(_fields(f64))).cuda()
    got = sb.sha256_blocks_cuda(blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, sb.sha256_blocks_plain(blocks))
    keys = lpn.derive_keys_device(layout, layout.template_tensor("cuda"),
                                  _fields(f64).cuda())
    want = lpn.derive_keys_batch(pk, sk, f64[:, :3], f64[:, 3])[0]
    assert np.array_equal(keys.cpu().numpy(), want)
