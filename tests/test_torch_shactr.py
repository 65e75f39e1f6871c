"""SHA-256-CTR streams: the plain stream states and the torch draw
selection (the stages of kernel B's twin, tests/test_torch_sigma_draws.py)
against the JAX package's numpy path (shactr.stream_u64s with
pallas_sha=False; its interpret-mode Pallas kernel is too slow for the CPU
suite).  Bit-exact (tolerance 0)."""
import numpy as np
import pytest
import torch

from pvac_hfhe_cppbyv_tpu.crypto import shactr as jshactr
from pvac_hfhe_cppbyv_tpu_torch.crypto import sha256_ctr, shactr

torch.set_num_threads(2)

LABELS = ["pvac.dom.x_seed", "pvac.dom.noise"]


def _words(seed, L, n=7):
    return np.random.default_rng(seed).integers(0, 1 << 64, (L, n), dtype=np.uint64)


def _np_lanes(words):
    return np.stack([(words & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (words >> np.uint64(32)).astype(np.uint32)], axis=-1)


@pytest.mark.parametrize("label", LABELS)
def test_stream_matches_jax_numpy(label):
    words = _words(1, 24)
    want = jshactr.stream_u64s(label, _np_lanes(words), 30)
    got = shactr.stream_u64s(label, sha256_ctr.lanes_from_u64(words), 30)
    assert np.array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("label,k,N", [("pvac.dom.x_seed", 32, 1024),
                                       ("pvac.dom.noise", 32, 512),
                                       ("pvac.dom.noise", 128, 140)])
def test_draws_and_take_matches_jax_numpy(label, k, N):
    """The last case has N close to k, so windows run short of uniques and
    the fallback flag fires."""
    words = _words(2, 64)
    jv, jt, jf = jshactr.draws_and_take(k, N, label, _np_lanes(words))
    v, t, f = shactr.draws_and_take(k, N, label, sha256_ctr.lanes_from_u64(words))
    assert np.array_equal(v.numpy(), jv)
    assert np.array_equal(t.numpy(), jt)
    assert np.array_equal(f.numpy(), jf)
    if N == 140:
        assert f.any()


@pytest.mark.parametrize("label", LABELS)
def test_scalar_stream_and_choose_k_match_jax(label):
    w = [3, 1 << 63, 12345, 7, 0, 1, 0xFFFFFFFFFFFFFFFF]
    a, b = shactr.CtrStream(label, w), jshactr.CtrStream(label, w)
    assert [a.rnd() for _ in range(9)] == [b.rnd() for _ in range(9)]
    assert [a.bounded(337) for _ in range(9)] == [b.bounded(337) for _ in range(9)]
    assert shactr.choose_k_scalar(128, 8192, label, w) == \
        jshactr.choose_k_scalar(128, 8192, label, w)


def test_choose_k_batch_matches_scalar():
    words = _words(3, 16, 5)
    idx, fb = shactr.choose_k_batch(48, 512, "pvac.dom.h_gen", words)
    assert not fb.any()
    for i in range(16):
        assert idx[i].tolist() == jshactr.choose_k_scalar(
            48, 512, "pvac.dom.h_gen", [int(x) for x in words[i]])
