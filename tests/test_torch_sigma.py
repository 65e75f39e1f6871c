"""σ rows: kernel C's plain twin, on taken row indices and noise bit
positions, against the JAX one-hot Pallas kernel in interpret mode and
the JAX host path (matrix.sigma_words), and the port's σ program against
the JAX host path for the same edge words.  Bit-exact (tolerance 0)."""
import dataclasses

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
from pvac_hfhe_cppbyv_tpu.crypto import matrix as jmatrix
from pvac_hfhe_cppbyv_tpu.crypto import shactr as jshactr
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.crypto import matrix, sigma_xor
from pvac_hfhe_cppbyv_tpu_torch.crypto.sha256_ctr import lanes_from_u64

torch.set_num_threads(2)


def _carry(pk, sk):
    pkf = dict(prm=dataclasses.asdict(pk.prm), canon_tag=pk.canon_tag, H=pk.H,
               ubk_perm=pk.ubk.perm, ubk_inv=pk.ubk.inv, H_digest=pk.H_digest,
               omega_B=pk.omega_B, powg_B=pk.powg_B)
    return tpv.keys_from_numpy(pkf, dict(prf_k=sk.prf_k, lpn_s_bits=sk.lpn_s_bits), device="cpu")


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
    ridx = rng.integers(0, n_rows + 1, (E, dc)).astype(np.int16)
    Hx = np.concatenate([H, np.zeros((1, mw), dtype=np.uint32)])
    want = np.bitwise_xor.reduce(Hx[ridx], axis=1) ^ onehot
    nbit = np.where(ntake, nvals, -1).astype(np.int16)
    for dt in (torch.int16, torch.int32):
        got = sigma_xor.sigma_rows_plain(_i32(Hx), torch.from_numpy(ridx).to(dt),
                                         torch.from_numpy(nbit).to(dt))
        assert np.array_equal(got.numpy().view(np.uint32), want)


def test_taken_indices_rows_match_jax(keys):
    """The kernel's input form, [E, k] int16 taken row indices and the
    taken noise bits, through the plain twin against the JAX host path
    (matrix.sigma_words) for every lane the draw window serves, and the
    taken rows against the scalar prg_choose_k."""
    jpk, _, (pk, _) = keys
    prm = pk.prm
    rng = np.random.default_rng(6)
    E = 64
    words = rng.integers(0, 1 << 64, (E, 7), dtype=np.uint64)
    words[:, 0] = pk.canon_tag
    ridx, nbit, fb = matrix.taken_indices(prm, lanes_from_u64(words))
    assert ridx.dtype == nbit.dtype == torch.int16
    assert ridx.shape == (E, prm.x_col_wt) and nbit.shape == (E, prm.err_wt + 16)
    got = sigma_xor.sigma_rows_plain(matrix.hx_tensor(pk.H), ridx, nbit).numpy().view(np.uint32)
    want = jmatrix.sigma_words(jpk, *(words[:, j] for j in range(1, 7)))
    ok = ~fb.numpy()
    # in "dense" most 64-draw noise windows run short of 48 unique bits
    assert ok.all() or prm.m_bits == 64
    assert np.array_equal(got[ok], want[ok])
    for e in np.nonzero(ok)[0][:4]:
        w = [int(x) for x in words[e]]
        assert sorted(ridx[e].tolist()) == sorted(
            jshactr.choose_k_scalar(prm.x_col_wt, prm.n_bits, "pvac.dom.x_seed", w))
        taken = nbit[e][nbit[e] >= 0].tolist()
        assert sorted(taken) == sorted(
            jshactr.choose_k_scalar(prm.err_wt, prm.m_bits, "pvac.dom.noise", w))


def test_dispatch_uses_twin_on_cpu():
    Hx = torch.zeros((5, 4), dtype=torch.int32)
    ridx = torch.tensor([[0, 4]], dtype=torch.int16)
    nbit = torch.tensor([[3, -1]], dtype=torch.int16)
    assert torch.equal(sigma_xor.sigma_rows(Hx, ridx, nbit),
                       sigma_xor.sigma_rows_plain(Hx, ridx, nbit))
    with pytest.raises(ValueError):
        sigma_xor.sigma_rows_cuda(Hx, ridx, nbit)


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
    E, mw, n_rows, k = 2048, 256, 16384, 128
    Hx = _i32(rng.integers(0, 1 << 32, (n_rows + 1, mw), dtype=np.uint64)).cuda()
    ridx = torch.from_numpy(rng.integers(0, n_rows + 1, (E, k)).astype(np.int16)).cuda()
    nv = np.stack([rng.choice(mw * 32, 144, replace=False) for _ in range(E)])
    nv[rng.random(nv.shape) < 0.1] = -1
    nbit = torch.from_numpy(nv.astype(np.int16)).cuda()
    for r, n in ((ridx, nbit), (ridx[:, :100].int(), nbit.int())):
        got = sigma_xor.sigma_rows_cuda(Hx, r, n)
        torch.cuda.synchronize()
        assert torch.equal(got, sigma_xor.sigma_rows_plain(Hx, r, n))
