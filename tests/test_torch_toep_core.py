"""Kernel E's plain twin, crypto/toep_core.toep_core_plain: a PRF core
from its Toeplitz key, nonce and LPN bits, against the JAX package's
chain for the same numpy-made inputs (the bitsliced numpy AES block
aesv.ctr_keystream_u64, then conv127, FV.canon and the nonzero select of
lpn._cores_tail2) and against the scalar toep_127 + hash_to_fp_nonzero.
Bit-exact (tolerance 0: GF(2) and field values).  The kernel itself runs
only on the card (the `cuda` test here; chip_smoke.py holds it against
the twin at the main path's shape)."""
import numpy as np
import pytest
import torch

from pvac_hfhe_cppbyv_tpu.core import fieldv as jFV
from pvac_hfhe_cppbyv_tpu.crypto import aesv
from pvac_hfhe_cppbyv_tpu.crypto import lpn as jlpn
from pvac_hfhe_cppbyv_tpu.crypto import toeplitz as jtoep
from pvac_hfhe_cppbyv_tpu_torch.core import fieldv as FV
from pvac_hfhe_cppbyv_tpu_torch.crypto import toep_core

torch.set_num_threads(2)

P_LIMBS = np.array([0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF], dtype=np.uint32)


def _inputs(seed, N):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 64, N, dtype=np.uint64)
    nonces[:3] = [(1 << 64) - 1, (1 << 32) - 1, 0]
    y = rng.integers(0, 1 << 32, (N, 4), dtype=np.uint64).astype(np.uint32)
    y[:, 3] &= 0x7FFFFFFF  # kernel A's 127 bits
    y[3, 3] |= 0x80000000  # bit 127 is never read
    y[4] = 0
    return keys, nonces, y


def _torch(keys, nonces, y):
    h = np.ascontiguousarray(nonces, dtype=np.uint64).view(np.uint32).reshape(-1, 2)
    return (torch.from_numpy(keys),
            torch.from_numpy(np.ascontiguousarray(h[:, 0]).view(np.int32)),
            torch.from_numpy(np.ascontiguousarray(h[:, 1]).view(np.int32)),
            torch.from_numpy(y.view(np.int32)))


def _jax_cores(keys, nonces, y):
    u = aesv.ctr_keystream_u64(keys, nonces, 1)  # [N, 2, 2] (lo, hi) u32
    top4 = np.stack([u[:, 0, 0], u[:, 0, 1], u[:, 1, 0], u[:, 1, 1]], axis=-1)
    r = jFV.canon(jtoep.conv127(y, top4))
    one = np.broadcast_to(np.array([1, 0, 0, 0], dtype=np.uint32), r.shape)
    return jFV.select(jFV.is_zero(r), one, r), top4


def test_plain_matches_jax_chain_and_scalar():
    keys, nonces, y = _inputs(5, 48)
    want, top4 = _jax_cores(keys, nonces, y)
    got = toep_core.toep_core_plain(*_torch(keys, nonces, y))
    assert got.dtype == torch.int64 and got.shape == (48, 4)
    assert np.array_equal(FV.to_u32(got), want)
    for n in range(6):
        t = top4[n].astype(np.uint64)
        w = y[n].astype(np.uint64)
        lo, hi = jtoep.toep_127_scalar([int(t[0] | t[1] << np.uint64(32)),
                                        int(t[2] | t[3] << np.uint64(32))],
                                       [int(w[0] | w[1] << np.uint64(32)),
                                        int(w[2] | w[3] << np.uint64(32))])
        assert FV.to_ints(got[n])[0] == jlpn.hash_to_fp_nonzero(lo, hi)


def test_zero_lpn_bits_give_one():
    keys, nonces, y = _inputs(6, 8)
    y[:] = 0
    got = toep_core.toep_core_plain(*_torch(keys, nonces, y))
    assert FV.to_ints(got) == [1] * 8


def test_conv_equal_to_p_gives_one():
    """y = 1 makes the product the top row itself: a top row equal to p
    (or to p plus bit 127, which the product drops) canonicalises to 0,
    which the core maps to 1; p - 1 stays."""
    y = torch.tensor([[1, 0, 0, 0]] * 3, dtype=torch.int32)
    tops = np.stack([P_LIMBS, P_LIMBS | np.array([0, 0, 0, 1 << 31], dtype=np.uint32),
                     P_LIMBS - np.array([1, 0, 0, 0], dtype=np.uint32)])
    r = toep_core.cores_from_ybits(y, torch.from_numpy(tops.view(np.int32)))
    assert FV.to_ints(r) == [1, 1, (1 << 127) - 2]


def test_dispatch_routes_by_device():
    keys, nonces, y = _inputs(7, 6)
    args = _torch(keys, nonces, y)
    assert torch.equal(toep_core.toep_core(*args), toep_core.toep_core_plain(*args))
    with pytest.raises(ValueError):
        toep_core.toep_core_cuda(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        toep_core.toep_core(*(a.to("meta") for a in args))


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys, nonces, y = _inputs(8, 4096)
    y[100:140] = 0
    args = _torch(keys, nonces, y)
    got = toep_core.toep_core_cuda(*(a.cuda() for a in args))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), toep_core.toep_core_plain(*args))
    assert FV.to_ints(got[100:140]) == [1] * 40
