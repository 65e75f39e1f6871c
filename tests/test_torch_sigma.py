"""σ rows: kernel C's plain twin against the JAX one-hot Pallas kernel in
interpret mode, and the port's σ program against the JAX host path
(matrix.sigma_words) for the same edge words.  Bit-exact (tolerance 0)."""
import dataclasses

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
from pvac_hfhe_cppbyv_tpu.crypto import matrix as jmatrix
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.crypto import matrix, sigma_xor

torch.set_num_threads(2)


def _carry(pk, sk):
    pkf = dict(prm=dataclasses.asdict(pk.prm), canon_tag=pk.canon_tag, H=pk.H,
               ubk_perm=pk.ubk.perm, ubk_inv=pk.ubk.inv, H_digest=pk.H_digest,
               omega_B=pk.omega_B, powg_B=pk.powg_B)
    return tpv.keys_from_numpy(pkf, dict(prf_k=sk.prf_k, lpn_s_bits=sk.lpn_s_bits))


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


# "dense": 48 noise bits of 64 and 16 columns of 64, so most edges' draw
# windows run short of unique values and the scalar fallback patches them
PARAMS = {
    "small": jpv.small_test_params(),
    "dense": dataclasses.replace(jpv.small_test_params(), m_bits=64, n_bits=64,
                                 h_col_wt=8, x_col_wt=16, err_wt=48),
}


@pytest.fixture(scope="module", params=sorted(PARAMS))
def keys(request):
    pk, sk = jpv.keygen(PARAMS[request.param])
    return pk, sk, _carry(pk, sk)


def test_plain_matches_onehot_pallas_interpret():
    import jax.numpy as jnp

    from pvac_hfhe_cppbyv_tpu.crypto import onehot_pallas as OH

    E, D, mw, n_rows, dc = 256, 16, 128, 300, 12
    rng = np.random.default_rng(41)
    nvals = np.stack([rng.choice(mw * 32, D, replace=False) for _ in range(E)])
    ntake = rng.random((E, D)) < 0.85
    word = (nvals // 32).astype(np.int32)
    masks = np.where(ntake, np.uint32(1) << (nvals % 32).astype(np.uint32),
                     np.uint32(0)).astype(np.uint32)
    onehot = np.asarray(OH.onehot_noise_words_interpret(
        jnp.asarray(word), jnp.asarray(masks), mw))
    H = rng.integers(0, 1 << 32, (n_rows, mw), dtype=np.uint64).astype(np.uint32)
    cidx = rng.integers(0, n_rows + 1, (E, dc)).astype(np.int32)
    Hx = np.concatenate([H, np.zeros((1, mw), dtype=np.uint32)])
    want = np.bitwise_xor.reduce(Hx[cidx], axis=1) ^ onehot
    got = sigma_xor.sigma_rows_plain(_i32(Hx), torch.from_numpy(cidx),
                                     torch.from_numpy(word), _i32(masks))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_sigma_words_match_jax_host_path(keys):
    jpk, _, (pk, _) = keys
    rng = np.random.default_rng(5)
    E = 96
    cols = [rng.integers(0, 1 << 64, E, dtype=np.uint64) for _ in range(3)]
    idx = rng.integers(0, jpk.prm.B, E).astype(np.uint64)
    ch = rng.integers(0, 2, E).astype(np.uint64)
    salt = rng.integers(0, 1 << 64, E, dtype=np.uint64)
    want = jmatrix.sigma_words(jpk, *cols, idx, ch, salt)
    got = matrix.sigma_words(pk, *cols, idx, ch, salt)
    assert np.array_equal(got, want)


def test_fresh_ciphertext_sigma_matches_jax(keys):
    """σ rows of a port-encrypted ciphertext, gathered from the device base
    through its LazySigma view (fallback rows patched at that point), equal
    the JAX host path's rows for the same edge words."""
    jpk, _, (pk, sk) = keys
    (C,) = tpv.enc_value_batch(pk, sk, [5])
    words = C.sigma.fixup.jobs[0].words[C.sigma.rows]
    want = jmatrix.sigma_words(jpk, *(words[:, j] for j in range(1, 7)))
    assert np.array_equal(np.asarray(C.sigma), want)


def test_hx_table_and_gen_H_match_jax(keys):
    jpk, _, (pk, _) = keys
    fresh = tpv.PubKey(prm=pk.prm, canon_tag=pk.canon_tag, H=None, ubk=None,
                       H_digest=b"", omega_B=0, powg_B=[])
    matrix.gen_H(fresh)
    assert np.array_equal(fresh.H, jpk.H) and fresh.H_digest == jpk.H_digest
    Hx = matrix.hx_tensor(fresh.H).numpy().view(np.uint32)
    assert np.array_equal(Hx[:-1], jpk.H) and not Hx[-1].any()


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    E, mw, n_rows = 2048, 256, 16384
    Hx = _i32(rng.integers(0, 1 << 32, (n_rows + 1, mw), dtype=np.uint64)).cuda()
    cidx = torch.from_numpy(rng.integers(0, n_rows + 1, (E, 144)).astype(np.int32)).cuda()
    nv = np.stack([rng.choice(mw * 32, 144, replace=False) for _ in range(E)])
    nword = torch.from_numpy((nv // 32).astype(np.int32)).cuda()
    nmask = _i32(np.uint32(1) << (nv % 32).astype(np.uint32)).cuda()
    got = sigma_xor.sigma_rows_cuda(Hx, cidx, nword, nmask)
    want = sigma_xor.sigma_rows_plain(Hx, cidx, nword, nmask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
