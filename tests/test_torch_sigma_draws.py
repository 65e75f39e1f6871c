"""Kernel B's plain twin, crypto/sigma_draws.taken_indices_plain: the
σ draws of many edges to their taken indices, against the JAX package's
draws_and_take (numpy path) compacted the same way, and the taken draws
against the scalar prg_choose_k.  Bit-exact (tolerance 0: integer
indices and flags), flagged lanes included.  The kernel itself runs only
on the card (the `cuda` test here; chip_smoke.py holds it against the
twin at the main path's shapes)."""
import dataclasses

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu.crypto import shactr as jshactr
from pvac_hfhe_cppbyv_tpu_torch.crypto import matrix, sha256_ctr, shactr, sigma_draws

torch.set_num_threads(2)

X_SEED, NOISE = "pvac.dom.x_seed", "pvac.dom.noise"

# "dense": 48 noise bits of 64 and 16 rows of 64, so most windows run
# short of first occurrences and the fallback flag fires for real
PARAMS = {
    "small": tpv.small_test_params(),
    "dense": dataclasses.replace(tpv.small_test_params(), m_bits=64, n_bits=64,
                                 h_col_wt=8, x_col_wt=16, err_wt=48),
    "default": tpv.Params(),
    # moduli that are not powers of two, and int32 indices
    "wide": dataclasses.replace(tpv.Params(), n_bits=40000, m_bits=33000),
}


def _words(seed, E):
    return np.random.default_rng(seed).integers(0, 1 << 64, (E, 7), dtype=np.uint64)


def _np_lanes(words):
    return np.stack([(words & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (words >> np.uint64(32)).astype(np.uint32)], axis=-1)


def _jax_taken(prm, words):
    """The JAX package's draws_and_take for both streams, compacted as the
    kernel writes them: (ridx, nbit, fb) numpy arrays."""
    lanes = _np_lanes(words)
    cv, ct, f1 = jshactr.draws_and_take(prm.x_col_wt, prm.n_bits, X_SEED, lanes)
    nv, nt, f2 = jshactr.draws_and_take(prm.err_wt, prm.m_bits, NOISE, lanes)
    ridx = np.full((len(words), prm.x_col_wt), prm.n_bits, dtype=np.int64)
    for e in range(len(words)):
        taken = cv[e][ct[e]]
        ridx[e, :len(taken)] = taken
    return ridx, np.where(nt, nv, -1), f1 | f2


@pytest.mark.parametrize("name,E", [("small", 64), ("dense", 64), ("default", 32),
                                    ("wide", 32)])
def test_plain_matches_jax_draws_and_take(name, E):
    prm = PARAMS[name]
    words = _words(len(name), E)
    ridx, nbit, fb = sigma_draws.taken_indices_plain(prm, sha256_ctr.lanes_from_u64(words))
    assert (ridx.dtype, nbit.dtype) == ((torch.int32,) * 2 if name == "wide" else (torch.int16,) * 2)
    assert ridx.shape == (E, prm.x_col_wt) and nbit.shape == (E, prm.err_wt + 16)
    assert fb.dtype == torch.bool and fb.shape == (E,)
    want = _jax_taken(prm, words)
    assert np.array_equal(ridx.numpy(), want[0])
    assert np.array_equal(nbit.numpy(), want[1])
    assert np.array_equal(fb.numpy(), want[2])
    # in "dense" nearly every noise window runs short of 48 unique bits
    assert bool(fb.any()) == (name == "dense")


@pytest.mark.parametrize("name", ["small", "dense", "default"])
def test_taken_draws_match_choose_k_scalar(name):
    """The taken row draws in column order and the taken noise draws in
    stream order are a prefix of the scalar prg_choose_k's picks, in its
    order: all of them on a lane the window serves, and on a flagged
    lane's stream that found k first occurrences."""
    prm = PARAMS[name]
    words = _words(7 + len(name), 24 if name == "default" else 48)
    ridx, nbit, fb = sigma_draws.taken_indices_plain(prm, sha256_ctr.lanes_from_u64(words))
    checked = 0
    for e in range(len(words))[:12]:
        w = [int(x) for x in words[e]]
        rows = jshactr.choose_k_scalar(prm.x_col_wt, prm.n_bits, X_SEED, w)
        bits = jshactr.choose_k_scalar(prm.err_wt, prm.m_bits, NOISE, w)
        got_rows = [r for r in ridx[e].tolist() if r != prm.n_bits]
        got_bits = [b for b in nbit[e].tolist() if b >= 0]
        assert got_rows == rows[:len(got_rows)] and got_bits == bits[:len(got_bits)]
        if not fb[e]:
            assert len(got_rows) == prm.x_col_wt and len(got_bits) == prm.err_wt
        checked += len(got_rows) == prm.x_col_wt
    assert checked > 0


def test_dispatch_uses_twin_on_cpu():
    prm = PARAMS["small"]
    lanes = sha256_ctr.lanes_from_u64(_words(3, 8))
    assert matrix.taken_indices is sigma_draws.taken_indices
    got, want = sigma_draws.taken_indices(prm, lanes), sigma_draws.taken_indices_plain(prm, lanes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        sigma_draws.taken_indices_cuda(prm, lanes)
    with pytest.raises(ValueError, match="unsupported device"):
        sigma_draws.taken_indices(prm, lanes.to("meta"))


def test_host_streams_refuse_other_devices():
    """The plain SHA-256-CTR states are a host route: off the CPU they
    raise and name kernel B rather than run on the device."""
    lanes = torch.zeros((2, 7, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="kernel B"):
        sha256_ctr.shactr_states(b"pvac.dom.x_seed", lanes, 2)
    with pytest.raises(ValueError, match="kernel B"):
        shactr.stream_u64s(X_SEED, lanes, 8)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, E in (("dense", 1024), ("small", 1000), ("default", 4096), ("wide", 2048)):
        prm = PARAMS[name]
        lanes = sha256_ctr.lanes_from_u64(_words(11, E), "cuda")
        got = sigma_draws.taken_indices_cuda(prm, lanes)
        torch.cuda.synchronize()
        want = sigma_draws.taken_indices_plain(prm, lanes.cpu())
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert bool(got[2].any()) == (name == "dense")
    with pytest.raises(ValueError, match="kernel B"):
        shactr.stream_u64s(X_SEED, lanes, 8)
