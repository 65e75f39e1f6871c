"""The plain AES-256-CTR twins, from raw keys (the first stage of kernel
A's twin) and from expanded round keys (kernel E's), against the JAX
package: the fused and the per-lane Pallas kernels in interpret mode and
the scalar AesCtr256 oracle.  Bit-exact (tolerance 0: integer keystream
words)."""
import numpy as np
import pytest
import torch

from pvac_hfhe_cppbyv_tpu.crypto import aes, aesv
from pvac_hfhe_cppbyv_tpu_torch.crypto import aes_ctr, toep_core

torch.set_num_threads(2)


def _halves(nonces):
    h = np.ascontiguousarray(nonces, dtype=np.uint64).view(np.uint32).reshape(-1, 2)
    return (torch.from_numpy(np.ascontiguousarray(h[:, 0]).view(np.int32)),
            torch.from_numpy(np.ascontiguousarray(h[:, 1]).view(np.int32)))


def _u64_stream(words, n):
    w = words[n].astype(np.uint64)
    return [int(x) for x in (w[:, 0::2] | (w[:, 1::2] << np.uint64(32))).reshape(-1)]


def test_plain_matches_fused_pallas_interpret():
    import jax.numpy as jnp

    from pvac_hfhe_cppbyv_tpu.crypto import aes_fused

    rng = np.random.default_rng(31)
    N, nblocks = 128, 40
    keys = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 64, size=(N,), dtype=np.uint64)
    nonces[:3] = [(1 << 64) - 7, (1 << 32) - 5, (1 << 64) - 1]
    nlo, nhi = _halves(nonces)
    want = np.asarray(aes_fused.aes_ctr_keystream_fused(
        jnp.asarray(aesv.expand_keys_bitsliced(keys)),
        jnp.asarray(nlo.numpy().view(np.uint32)),
        jnp.asarray(nhi.numpy().view(np.uint32)), nblocks, interpret=True))
    got = aes_ctr.aes_ctr_keystream_plain(torch.from_numpy(keys), nlo, nhi, nblocks)
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("nonce", [(1 << 64) - 3, (1 << 32) - 2, 0, 0x0123456789ABCDEF])
def test_plain_matches_scalar_oracle(nonce):
    """Counter carries: low-u32 wrap into the high half, and the 64-bit
    wrap (the high 8 bytes of the counter block stay zero)."""
    rng = np.random.default_rng(nonce & 0xFFFF)
    keys = rng.integers(0, 256, size=(2, 32), dtype=np.uint8)
    nonces = np.array([nonce, nonce ^ 0x5555], dtype=np.uint64)
    nlo, nhi = _halves(nonces)
    words = aes_ctr.aes_ctr_keystream_plain(torch.from_numpy(keys), nlo, nhi, 6)
    words = words.numpy().view(np.uint32)
    for n in range(2):
        want = aes.AesCtr256(bytes(keys[n]), int(nonces[n])).fill_u64(12)
        assert _u64_stream(words, n) == want


def test_rk_plain_matches_pallas_interpret_and_oracle():
    """Kernel E's twin against aes_pallas.aes_ctr_keystream_pallas (its TPU
    kernel, interpret mode) with bitsliced round-key masks, N = 3 lanes of
    40 blocks whose counters cross the 2^32 and the 2^64 wrap."""
    import jax.numpy as jnp

    from pvac_hfhe_cppbyv_tpu.crypto import aes_pallas

    rng = np.random.default_rng(21)
    N, nblocks = 3, 40
    keys = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
    nonces = np.array([(1 << 32) - 7, (1 << 64) - 9, 0x0123456789ABCDEF],
                      dtype=np.uint64)
    nlo, nhi = _halves(nonces)
    rk_lanes = np.ascontiguousarray(np.moveaxis(aesv.expand_keys_bitsliced(keys), -1, 0))
    want = np.asarray(aes_pallas.aes_ctr_keystream_pallas(
        jnp.asarray(rk_lanes), jnp.asarray(nlo.numpy().view(np.uint32)),
        jnp.asarray(nhi.numpy().view(np.uint32)), nblocks, interpret=True))
    rk = aes_ctr.round_keys(torch.from_numpy(keys))
    got = aes_ctr.aes_ctr_keystream_rk_plain(rk, nlo, nhi, nblocks).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    for n in range(N):
        assert _u64_stream(got, n) == aes.AesCtr256(bytes(keys[n]), int(nonces[n])).fill_u64(2 * nblocks)


def test_round_keys_match_scalar_schedule():
    keys = np.random.default_rng(2).integers(0, 256, size=(4, 32), dtype=np.uint8)
    rk = aes_ctr.round_keys(torch.from_numpy(keys)).numpy().view(np.uint32)
    for n in range(4):
        assert [int(w) for w in rk[n]] == list(aes.expand_key_256(bytes(keys[n])))


def test_dispatch_uses_twin_on_cpu():
    """Kernel E's dispatcher (crypto/toep_core.toep_core) runs the twin,
    whose first stages are the round keys and the one-block stream, for
    CPU tensors; its CUDA wrapper refuses them."""
    keys = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 32), dtype=np.uint8))
    z = torch.zeros(2, dtype=torch.int32)
    y = torch.tensor([[5, 0, 0, 0], [-1, -1, -1, 0x7FFFFFFF]], dtype=torch.int32)
    top = aes_ctr.aes_ctr_keystream_rk_plain(aes_ctr.round_keys(keys), z, z, 1)
    assert torch.equal(top, aes_ctr.aes_ctr_keystream_plain(keys, z, z, 1))
    assert torch.equal(toep_core.toep_core(keys, z, z, y),
                       toep_core.cores_from_ybits(y, top))
    with pytest.raises(ValueError):
        toep_core.toep_core_cuda(keys, z, z, y)
