"""The statistical tests of tests/test_stats.py on the port (CPU route,
small Params).

Statistical / distributional tests (ports of tests/test_hg.cpp,
test_sigma_lpn.cpp, test_lpn.cpp z-test cores) on small params."""
import numpy as np
import pytest

import pvac_hfhe_cppbyv_tpu_torch as pvac
from pvac_hfhe_cppbyv_tpu_torch.core import bitvec as BV


@pytest.fixture(scope="module")
def small_keys():
    """A small-params key pair of the port, on the CPU."""
    return pvac.keygen(pvac.small_test_params(), device="cpu")


def test_hypergraph_stats(small_keys):
    """test_hg.cpp: degree stats, connectivity, pairwise intersections."""
    pk, _ = small_keys
    prm = pk.prm
    m, n, k = prm.m_bits, prm.n_bits, prm.h_col_wt
    H = pk.H  # [n, mw] packed columns
    # column weights exactly k
    assert (BV.popcnt(H) == k).all()
    # vertex degrees ~ Poisson(lambda = n*k/m)
    bits = np.unpackbits(
        H.view(np.uint8), axis=1, bitorder="little"
    )[:, :m]  # [n, m]
    vdeg = bits.sum(axis=0)
    lam = n * k / m
    assert abs(vdeg.mean() - lam) < 5
    assert vdeg.min() > 0  # every vertex covered (connectivity proxy)
    # connectivity: union-find over hyperedges
    parent = np.arange(m)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for c in range(n):
        vs = np.nonzero(bits[c])[0]
        r0 = find(vs[0])
        for v in vs[1:]:
            parent[find(v)] = r0
    roots = {find(v) for v in range(m)}
    assert len(roots) == 1  # single connected component
    # pairwise column intersections ~ k^2/m
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, n, size=(400, 2))
    inter = [
        int(BV.popcnt(H[a] & H[b])) for a, b in pairs if a != b
    ]
    ix = k * k / m
    assert abs(np.mean(inter) - ix) < 1.0


def test_sigma_density_and_balance(small_keys):
    """test_sigma_lpn.cpp: σ bit density ~ 0.5 with z-test bounds."""
    pk, sk = small_keys
    C = pvac.enc_value(pk, sk, 987654321)
    m = pk.prm.m_bits
    dens = BV.popcnt(C.sigma) / m
    # per-edge density z-test: sd of Binomial(m, .5)/m
    sd = 0.5 / np.sqrt(m)
    z = (dens - 0.5) / sd
    assert (np.abs(z) < 6).all()
    # aggregate
    zz = (dens.mean() - 0.5) / (sd / np.sqrt(len(dens)))
    assert abs(zz) < 6


def test_sigma_pairwise_intersection(small_keys):
    """Pairwise σ AND-weights concentrate around m/4."""
    pk, sk = small_keys
    C = pvac.enc_value(pk, sk, 5555)
    m = pk.prm.m_bits
    E = C.n_edges
    sd = np.sqrt(m) / 4
    for i in range(0, E - 1, 3):
        w = int(BV.popcnt(C.sigma[i] & C.sigma[i + 1]))
        z = (w - m / 4) / sd
        assert abs(z) < 7


def test_lpn_noise_rate(small_keys):
    """test_lpn.cpp: the PRF noise process flips ~tau of the LPN bits.
    Verified indirectly: prf outputs over many seeds are uniform-ish
    (avalanche) and never zero."""
    pk, sk = small_keys
    from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn as L

    seeds = np.random.default_rng(9).integers(
        0, 1 << 64, size=(64, 3), dtype=np.uint64
    )
    out = L.prf_R_batch(pk, sk, seeds)
    from pvac_hfhe_cppbyv_tpu_torch.core import fieldv as FV

    vals = FV.to_ints(out)
    assert len(set(vals)) == len(vals)  # collision-free (test_prf_ext.cpp)
    assert all(v != 0 for v in vals)
    # avalanche: hamming weight of consecutive xors within [40, 88]
    hw = [bin(vals[i] ^ vals[i + 1]).count("1") for i in range(len(vals) - 1)]
    assert 40 < np.mean(hw) < 88


def test_prf_domain_separation(small_keys):
    """prf_R vs prf_R_noise on the same seed differ (test_prf.cpp:62-82)."""
    pk, sk = small_keys
    seed = pvac.RSeed(ztag=1, nonce=pvac.Nonce128(2, 3))
    assert pvac.prf_R(pk, sk, seed) != pvac.prf_R_noise(pk, sk, seed)
    seed2 = pvac.RSeed(ztag=1, nonce=pvac.Nonce128(2, 4))
    assert pvac.prf_R(pk, sk, seed) != pvac.prf_R(pk, sk, seed2)
