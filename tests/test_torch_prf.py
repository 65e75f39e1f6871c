"""The PRF's torch math against the JAX package's numpy functions: limb
field ops, the 127-bit Toeplitz convolution, the LPN core tail
(the JAX cores_from_streams, padded form, against the port's parity stage
and cores_from_ybits), and whole prf_R cores for the same
keys.  Bit-exact (tolerance 0: integer and GF(2) values)."""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
from pvac_hfhe_cppbyv_tpu.core import fieldv as jFV
from pvac_hfhe_cppbyv_tpu.crypto import lpn as jlpn
from pvac_hfhe_cppbyv_tpu.crypto import toeplitz as jtoep
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.core import fieldv as FV
from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn, lpn_ybits, toep_core, toeplitz

torch.set_num_threads(2)

P = (1 << 127) - 1


def _carry(pk, sk):
    pkf = dict(prm=dataclasses.asdict(pk.prm), canon_tag=pk.canon_tag, H=pk.H,
               ubk_perm=None, ubk_inv=None, H_digest=pk.H_digest,
               omega_B=pk.omega_B, powg_B=pk.powg_B)
    return tpv.keys_from_numpy(pkf, dict(prf_k=sk.prf_k, lpn_s_bits=sk.lpn_s_bits), device="cpu")


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _field(rng, n):
    vals = [int(x) % P for x in rng.integers(0, 1 << 63, n, dtype=np.uint64)]
    vals += [0, 1, P - 1, (1 << 96) + 5, P - (1 << 64)]
    return jFV.from_ints([v * (v + 3) % P for v in vals])


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "inv", "canon"])
def test_fieldv_matches_jax(op):
    rng = np.random.default_rng(["add", "sub", "mul", "neg", "inv", "canon"].index(op))
    a, b = _field(rng, 64), _field(rng, 64)[::-1].copy()
    if op == "canon":
        a = _u32(rng, (64, 4))  # arbitrary 128-bit values, bit 127 included
        a[0] = 0xFFFFFFFF
    ta, tb = FV.from_u32(a), FV.from_u32(b)
    if op in ("neg", "inv", "canon"):
        want, got = getattr(jFV, op)(a), getattr(FV, op)(ta)
    else:
        want, got = getattr(jFV, op)(a, b), getattr(FV, op)(ta, tb)
    assert np.array_equal(FV.to_u32(got), want)


def test_canon_u64_limbs_matches_jax():
    rng = np.random.default_rng(3)
    acc = rng.integers(0, 1 << 62, (32, 4), dtype=np.uint64)
    want = jFV.canon_u64_limbs(acc)
    assert np.array_equal(FV.to_u32(FV.canon_u64_limbs(torch.from_numpy(acc.astype(np.int64)))), want)


def test_conv127_matches_jax():
    rng = np.random.default_rng(4)
    y, top = _u32(rng, (40, 4)), _u32(rng, (40, 4))
    y[:, 3] &= 0x7FFFFFFF
    top[:, 3] &= 0x7FFFFFFF
    want = jtoep.conv127(y, top)
    got = toeplitz.conv127(FV.from_u32(y), FV.from_u32(top))
    assert np.array_equal(FV.to_u32(got), want)


@pytest.mark.parametrize("lpn_n", [256, 320])
def test_cores_from_streams_matches_jax(lpn_n):
    """320 bits = 5 u64 secret words: the non-power-of-two case."""
    prm = dataclasses.replace(jpv.small_test_params(), lpn_n=lpn_n)
    rng = np.random.default_rng(lpn_n)
    N, nb = 12, jlpn.n_ybits_blocks(prm)
    u64s = _u32(rng, (N, 2 * nb, 2))
    u64s[0, prm.s_words64] = (0xFFFFFFFF, 0xFFFFFFFF)  # a rejected noise draw
    top = _u32(rng, (N, 2, 2))
    s32 = _u32(rng, (2 * prm.s_words64,))
    jr, jrej = jlpn.cores_from_streams(u64s, top, s32, prm)
    bits, rej = lpn_ybits.parity_noise_rows(
        torch.from_numpy(u64s.view(np.int32)), torch.from_numpy(s32.view(np.int32)),
        min(127, prm.lpn_t), prm.lpn_tau_num, prm.lpn_tau_den)
    r = toep_core.cores_from_ybits(lpn_ybits.pack_ybits(bits),
                                   torch.from_numpy(top.view(np.int32)))
    assert np.array_equal(FV.to_u32(r), jr)
    assert np.array_equal(rej.numpy(), jrej) and rej[0].any()


@pytest.mark.parametrize("params", ["small", "default"])
def test_prf_cores_batch_matches_jax(params):
    """Whole prf_R cores with carried keys.  The default case runs a few
    full-size cores (4128 AES blocks each) through the plain twin."""
    if params == "small":
        jpk, jsk = jpv.keygen(jpv.small_test_params())
    else:
        g = pathlib.Path(__file__).parent / "golden" / "default"
        jpk, jsk = jpv.load_pklite(f"{g}/pklite.bin"), jpv.load_sk(f"{g}/sk.bin")
    pk, sk = _carry(jpk, jsk)
    rng = np.random.default_rng(11)
    n = 24 if params == "small" else 3
    seeds = rng.integers(0, 1 << 64, (n, 3), dtype=np.uint64)
    doms = np.array([jlpn.DOM_HASH[d] for d in (
        "pvac.prf.r.1", "pvac.prf.r.2", "pvac.prf.noise.3")], dtype=np.uint64)
    dh = doms[np.arange(n) % 3]
    want = jlpn.prf_cores_batch(jpk, jsk, seeds, dh)
    got = lpn.prf_cores_batch(pk, sk, seeds, dh)
    assert np.array_equal(got, want)
    assert FV.to_ints(lpn.prf_R_batch(pk, sk, seeds[:2])) == \
        jFV.to_ints(jlpn.prf_R_batch(jpk, jsk, seeds[:2]))


def test_exact_scalar_core_matches_batch():
    """The exact fallback that replaces a core whose noise draw hit a
    bounded rejection gives the batch value when no rejection occurs."""
    jpk, jsk = jpv.keygen(jpv.small_test_params())
    pk, sk = _carry(jpk, jsk)
    seeds = np.array([[1, 2, 3], [1 << 63, 5, 7]], dtype=np.uint64)
    dh = np.array([jlpn.DOM_HASH["pvac.prf.r.2"]] * 2, dtype=np.uint64)
    batch = lpn.prf_cores_batch(pk, sk, seeds, dh)
    for n in range(2):
        seed = tpv.RSeed(int(seeds[n, 0]), tpv.Nonce128(int(seeds[n, 1]), int(seeds[n, 2])))
        assert np.array_equal(lpn._prf_core_exact_scalar(pk, sk, seed, int(dh[n])), batch[n])
