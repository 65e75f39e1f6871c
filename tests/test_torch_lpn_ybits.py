"""Kernel A's plain twin (lpn_ybits_plain: AES-256-CTR keystream, LPN
parity and noise, packed to 127 bits per core) against the JAX package's
scalar lpn_make_ybits and the port's own, at small and default Params and
at secrets of 4 and 5 u64 words (strides 5 and 6, so rows start inside
AES blocks); the bounded-rejection flag on hand-built keystreams; whole
prf_R cores against the JAX package at lpn_n 320.  Bit-exact (tolerance
0: GF(2) values)."""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
from pvac_hfhe_cppbyv_tpu.crypto import lpn as jlpn
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.core.bits import from_np_u32
from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn, lpn_ybits

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
DOMS = ("pvac.prf.r.1", "pvac.prf.r.3", "pvac.prf.noise.2")


def _carry(pk, sk):
    pkf = dict(prm=dataclasses.asdict(pk.prm), canon_tag=pk.canon_tag, H=None,
               ubk_perm=None, ubk_inv=None, H_digest=pk.H_digest,
               omega_B=pk.omega_B, powg_B=pk.powg_B)
    return tpv.keys_from_numpy(pkf, dict(prf_k=sk.prf_k, lpn_s_bits=sk.lpn_s_bits),
                               device="cpu")


@pytest.fixture(scope="module", params=["small", "small320", "default"])
def keys(request):
    if request.param == "default":
        g = GOLDEN / "default"
        jpk, jsk = jpv.load_pklite(str(g / "pklite.bin")), jpv.load_sk(str(g / "sk.bin"))
    else:
        prm = jpv.small_test_params()
        if request.param == "small320":
            prm = dataclasses.replace(prm, lpn_n=320)
        jpk, jsk = jpv.keygen(prm)
    return (jpk, jsk, *_carry(jpk, jsk))


def _y_words(ybits):
    """The first 127 bits of a reference ybits list as 4 u32 words."""
    v = (ybits[0] | ybits[1] << 64) & ((1 << 127) - 1)
    return [(v >> (32 * k)) & 0xFFFFFFFF for k in range(4)]


def test_twin_matches_scalar_lpn_make_ybits(keys):
    jpk, jsk, pk, sk = keys
    prm = pk.prm
    n = 2 if prm.lpn_n == 4096 else 6
    rng = np.random.default_rng(prm.lpn_n)
    seeds = [tpv.RSeed(int(a), tpv.Nonce128(int(b), int(c)))
             for a, b, c in rng.integers(0, 1 << 64, (n, 3), dtype=np.uint64)]
    doms = [DOMS[i % 3] for i in range(n)]
    kn = [lpn.derive_aes_key(pk, sk, s, d) for s, d in zip(seeds, doms)]
    key_t = torch.frombuffer(bytearray(b"".join(k for k, _ in kn)), dtype=torch.uint8)
    key_t = key_t.reshape(n, 32)
    nonces = np.array([nc for _, nc in kn], dtype=np.uint64).view(np.uint32).reshape(n, 2)
    y, rej = lpn_ybits.lpn_ybits_plain(
        key_t, from_np_u32(nonces[:, 0].copy()), from_np_u32(nonces[:, 1].copy()),
        lpn.s32_tensor(sk), min(127, prm.lpn_t), prm.lpn_tau_num, prm.lpn_tau_den)
    got = y.numpy().view(np.uint32)
    assert not rej.any()
    for i, (s, d) in enumerate(zip(seeds, doms)):
        want = _y_words(jlpn.lpn_make_ybits(jpk, jsk, s, d, 127))
        assert [int(w) for w in got[i]] == want
        assert _y_words(lpn.lpn_make_ybits(pk, sk, s, d, 127)) == want


@pytest.mark.parametrize("lpn_n", [256, 320, 4096])
def test_rejection_flag_on_hand_built_stream(lpn_n):
    """A noise word at or above 2^64 - den flags its core; one just below
    does not.  The parity stage alone, on a keystream built by hand."""
    prm = dataclasses.replace(tpv.small_test_params(), lpn_n=lpn_n)
    sw, rows, den = prm.s_words64, 127, prm.lpn_tau_den
    rng = np.random.default_rng(lpn_n + 1)
    nb = lpn_ybits.n_stream_blocks(rows, sw)
    u64s = rng.integers(0, 1 << 32, (4, 2 * nb, 2), dtype=np.uint64).astype(np.uint32)
    u64s[:, :, 1] &= 0x7FFFFFFF  # no accidental rejection
    top = 0xFFFFFFFF
    u64s[0, 3 * (sw + 1) + sw] = (top - den + 1, top)  # x = 2^64 - den: rejected
    u64s[1, 126 * (sw + 1) + sw] = (top, top)  # the last row: rejected
    u64s[2, 5 * (sw + 1) + sw] = (top - den, top)  # x = 2^64 - den - 1: accepted
    s32 = from_np_u32(rng.integers(0, 1 << 32, 2 * sw, dtype=np.uint64).astype(np.uint32))
    y, rej = lpn_ybits.ybits_from_stream(torch.from_numpy(u64s.view(np.int32)), s32,
                                         rows, prm.lpn_tau_num, den)
    assert rej.tolist() == [True, True, False, False]
    # the accepted boundary draw's noise bit: (lo & (den-1)) < num
    e = int(((top - den) & (den - 1)) < prm.lpn_tau_num)
    bits, _ = lpn_ybits.parity_noise_rows(torch.from_numpy(u64s.view(np.int32)), s32,
                                          rows, prm.lpn_tau_num, den)
    u = u64s[2, 5 * (sw + 1): 5 * (sw + 1) + sw].astype(np.uint64)
    s = s32.numpy().view(np.uint32).reshape(sw, 2).astype(np.uint64)
    anded = (u[:, 0] & s[:, 0]) | (u[:, 1] & s[:, 1]) << np.uint64(32)
    dot = bin(int(np.bitwise_xor.reduce(anded))).count("1") & 1
    assert int(bits[2, 5]) == dot ^ e
    yw = y.numpy().view(np.uint32)
    assert (int(yw[2, 0]) >> 5) & 1 == dot ^ e


def test_pack_ybits_bit_order():
    bits = torch.zeros((2, 127), dtype=torch.int64)
    bits[0, [0, 31, 32, 96, 126]] = 1
    bits[1, 64] = 1
    y = lpn_ybits.pack_ybits(bits).numpy().view(np.uint32)
    assert [int(w) for w in y[0]] == [0x80000001, 1, 0, 0x40000001]
    assert [int(w) for w in y[1]] == [0, 0, 1, 0]


def test_prf_cores_batch_matches_jax_at_lpn_n_320():
    """Whole prf_R cores through the twin at a 5-word secret (stride 6)."""
    jpk, jsk = jpv.keygen(dataclasses.replace(jpv.small_test_params(), lpn_n=320))
    pk, sk = _carry(jpk, jsk)
    rng = np.random.default_rng(320)
    seeds = rng.integers(0, 1 << 64, (9, 3), dtype=np.uint64)
    dh = np.array([jlpn.DOM_HASH[d] for d in DOMS], dtype=np.uint64)[np.arange(9) % 3]
    assert np.array_equal(lpn.prf_cores_batch(pk, sk, seeds, dh),
                          jlpn.prf_cores_batch(jpk, jsk, seeds, dh))


def test_dispatch_uses_twin_on_cpu():
    keys = torch.zeros((2, 32), dtype=torch.uint8)
    z = torch.zeros(2, dtype=torch.int32)
    s32 = torch.arange(8, dtype=torch.int32)
    args = (keys, z, z, s32, 127, 1, 8)
    for a, b in zip(lpn_ybits.lpn_ybits(*args), lpn_ybits.lpn_ybits_plain(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        lpn_ybits.lpn_ybits_cuda(*args)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    for lpn_n, n in ((4096, 256), (320, 512), (256, 100)):
        sw = (lpn_n + 63) // 64
        keys = torch.from_numpy(rng.integers(0, 256, (n, 32), dtype=np.uint8)).cuda()
        nonces = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        nonces[0] = (1 << 64) - 2
        h = nonces.view(np.uint32).reshape(n, 2)
        nlo, nhi = from_np_u32(h[:, 0].copy(), "cuda"), from_np_u32(h[:, 1].copy(), "cuda")
        s32 = from_np_u32(rng.integers(0, 1 << 32, 2 * sw, dtype=np.uint64).astype(np.uint32),
                          "cuda")
        got = lpn_ybits.lpn_ybits_cuda(keys, nlo, nhi, s32, 127, 1, 8)
        torch.cuda.synchronize()
        want = lpn_ybits.lpn_ybits_plain(keys, nlo, nhi, s32, 127, 1, 8)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
