"""The fused launch of kernels B and C (crypto/sigma_fused.py): the rule
that routes σ to it (crypto/matrix.fused_engages), the engine's count of
the edges it took, the twins of the producers' share of the dedup, of the
ring's bank order and of the consumers' staggered walk, and, marked
``cuda``, the kernel bit-exact against B then C and against the twins, its
ring against the order's twin, its wait totals.

The CPU tests stand a stub in for the launcher; the module imports no JAX,
so ``python3 -m pytest --noconftest -m cuda tests/test_torch_sigma_fused.py``
runs the card's tests on a machine without it."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.crypto import matrix, shactr, sigma_draws, sigma_fused, sigma_xor
from pvac_hfhe_cppbyv_tpu_torch.crypto.sha256_ctr import lanes_from_u64
from pvac_hfhe_cppbyv_tpu_torch.params import Params
from pvac_hfhe_cppbyv_tpu_torch.types import Dom

SMALL = tpv.small_test_params()
DEFAULT = Params()
# 64 rows and bits: most windows run short of first occurrences, so lanes
# are flagged for the scalar fallback
DENSE = dataclasses.replace(SMALL, m_bits=64, n_bits=64, h_col_wt=8, x_col_wt=16, err_wt=48)


def _table(prm, rng, device="cpu"):
    H = rng.integers(0, 1 << 32, (prm.n_bits, prm.sigma_words32), dtype=np.uint64)
    return matrix.hx_tensor(H.astype(np.uint32), device)


def _lanes(E, rng, device="cpu"):
    return lanes_from_u64(rng.integers(0, 1 << 64, (E, 7), dtype=np.uint64), device)


def _card_table(prm, mw=None):
    """Something shaped like Hx on a card: the rule reads shape and device."""
    return types.SimpleNamespace(shape=(prm.n_bits + 1, mw or prm.sigma_words32),
                                 device=torch.device("cuda", 0))


@pytest.mark.parametrize("prm", [SMALL, DEFAULT], ids=["small", "default"])
def test_rule_takes_the_fused_launch_for_the_whole_table_on_a_card(prm, monkeypatch):
    monkeypatch.setattr(sigma_fused, "fits", lambda p, Hx: True)
    assert matrix.fused_engages(prm, _card_table(prm))
    # a tp rank's block of columns, whether it starts at bit 0 or further on
    half = prm.sigma_words32 // 2
    assert not matrix.fused_engages(prm, _card_table(prm, half))
    assert not matrix.fused_engages(prm, _card_table(prm, half), 32 * half)
    assert not matrix.fused_engages(prm, _card_table(prm), 32)
    # the table on the CPU
    assert not matrix.fused_engages(prm, _table(SMALL, np.random.default_rng(1)))


def test_rule_keeps_b_then_c_for_a_grid_wider_than_the_card(monkeypatch):
    monkeypatch.setattr(sigma_fused, "fits", lambda p, Hx: False)
    assert not matrix.fused_engages(DEFAULT, _card_table(DEFAULT))


def _stub_launcher(monkeypatch):
    """Route every σ pass to the fused launcher, which runs the twins and
    counts its edges."""
    calls = []

    def launch(prm, Hx, lanes):
        calls.append(lanes.shape[0])
        return sigma_fused.sigma_rows_fused_plain(prm, Hx, lanes)

    monkeypatch.setattr(matrix, "fused_engages",
                        lambda prm, Hx, bit_lo=0: bit_lo == 0 and Hx.shape[1] == prm.sigma_words32)
    monkeypatch.setattr(sigma_fused, "sigma_rows_fused_cuda", launch)
    return calls


@pytest.mark.parametrize("E", [1, 300])
def test_sigma_device_routes_by_the_rule(E, monkeypatch):
    rng = np.random.default_rng(E)
    Hx, lanes = _table(SMALL, rng), _lanes(E, rng)
    ridx, nbit, fb = sigma_draws.taken_indices_plain(SMALL, lanes)
    want = sigma_xor.sigma_rows_plain(Hx, ridx, nbit)
    calls = _stub_launcher(monkeypatch)
    sig, got_fb = matrix.sigma_device(SMALL, Hx, lanes)
    assert calls == [E] and torch.equal(sig, want) and torch.equal(got_fb, fb)
    # a block of columns goes through B then C, not the launcher
    blk, _ = matrix.sigma_device(SMALL, Hx[:, 8:].contiguous(), lanes, 32 * 8)
    assert calls == [E] and torch.equal(blk, want[:, 8:])


def test_twin_rows_match_the_scalar_draws():
    """The twin's rows: the XOR of H's rows at the scalar prg_choose_k row
    draws, with the scalar noise draws' bits flipped; flagged lanes agree
    with B's twin."""
    rng = np.random.default_rng(3)
    Hx, words = _table(SMALL, rng), rng.integers(0, 1 << 64, (6, 7), dtype=np.uint64)
    sig, fb = sigma_fused.sigma_rows_fused_plain(SMALL, Hx, lanes_from_u64(words))
    H = Hx.numpy().view(np.uint32)
    for e, w in enumerate(words.tolist()):
        want = np.bitwise_xor.reduce(
            H[shactr.choose_k_scalar(SMALL.x_col_wt, SMALL.n_bits, Dom.X_SEED, w)])
        for b in shactr.choose_k_scalar(SMALL.err_wt, SMALL.m_bits, Dom.NOISE, w):
            want[b // 32] ^= np.uint32(1 << (b % 32))
        assert np.array_equal(sig[e].numpy().view(np.uint32), want)
    dense = _lanes(512, rng)
    got_fb = sigma_fused.sigma_rows_fused_plain(DENSE, _table(DENSE, rng), dense)[1]
    assert got_fb.any() and torch.equal(got_fb, sigma_draws.taken_indices_plain(DENSE, dense)[2])
    assert not fb.any()


@pytest.mark.parametrize("prm, width", [(SMALL, 32), (DENSE, 16),
                                        (dataclasses.replace(SMALL, x_col_wt=20), 24),
                                        (dataclasses.replace(DEFAULT, n_bits=40000,
                                                             x_col_wt=130), 132)])
def test_ring_rows_pad_to_16_bytes(prm, width):
    assert sigma_fused._ridx_width(prm) == width


def test_short_launches_draw_half_chunks():
    """Four super-tiles or more keep the full chunk; fewer halve it."""
    assert sigma_fused.draw_chunk(4 * 16 * 128, 128, 16) == 16
    assert sigma_fused.draw_chunk(4 * 16 * 128 - 1, 128, 16) == 8
    assert sigma_fused.draw_chunk(1, 1, 16) == 8


@pytest.mark.parametrize("prm", [DEFAULT, SMALL, DENSE], ids=["default", "small", "dense"])
@pytest.mark.parametrize("E", [1, 3001, 70001], ids=["one", "short", "long"])
def test_producer_walks_leave_the_message_warp_free(prm, E):
    """Every chunk of a launch (full, half and the last cut short): each of
    its live streams is walked once, by one of the first warps - 1, in
    stream order, in 4 rounds of walks at most; the last warp, which builds
    the next chunk's messages meanwhile, walks none.  At 9 producer warps a
    full chunk takes as many rounds of walks as on all of them, and its
    counters fill whole rounds of the 9 warps' lanes at default Params."""
    n_slices, warps = prm.sigma_words32 // 2, 9
    chunk = sigma_fused.draw_chunk(E, n_slices, 16)
    st_edges = chunk * n_slices
    heres = {max(0, min(chunk, E - (s * st_edges + c * chunk)))
             for s in range(-(-E // st_edges)) for c in range(n_slices)}
    for n_here in heres:
        walks = sigma_fused.producer_walks(n_here, warps)
        assert walks[-1] == []
        drawn = [w for warp in walks for w in warp]
        assert sorted(drawn) == [(a, e) for a in (0, 1) for e in range(n_here)]
        for warp in walks:
            assert warp == sorted(warp)
        assert max(len(w) for w in walks) <= 4
    # a full chunk's 32 streams: 4 rounds of walks on 8 warps, as on all 9
    assert max(len(w) for w in sigma_fused.producer_walks(16, warps)) == -(-32 // warps) == 4
    refills = sum(-(-(k + shactr.OVERSHOOT) // 4) for k in (prm.x_col_wt, prm.err_wt))
    if prm is DEFAULT:
        assert 16 * refills == 4 * 32 * warps


# one set of Params a row width and index dtype: int16 at SW 2 and 1 (kp
# 32, 16, 128), int32 with an even and an odd number of quads (kp 132)
INT32 = dataclasses.replace(SMALL, n_bits=40000, x_col_wt=130)


def _padded_ridx(prm, E, rng):
    ridx = sigma_draws.taken_indices_plain(prm, _lanes(E, rng))[0]
    kp = sigma_fused._ridx_width(prm)
    return torch.nn.functional.pad(ridx, (0, kp - ridx.shape[1]), value=prm.n_bits)


@pytest.mark.parametrize("prm", [SMALL, DENSE, INT32], ids=["small", "dense", "int32"])
@pytest.mark.parametrize("sw", [1, 2])
def test_bank_order_permutes_each_row_by_ascending_key(prm, sw):
    rng = np.random.default_rng(sw)
    ridx = _padded_ridx(prm, 300, rng)
    got = sigma_fused.bank_order_plain(ridx, sw, prm.n_bits)
    assert got.dtype == ridx.dtype and got.shape == ridx.shape
    assert torch.equal(torch.sort(got, dim=1).values, torch.sort(ridx, dim=1).values)
    pad = got == prm.n_bits
    key = torch.where(pad, 32 // sw, got.long() % (32 // sw))
    assert bool((key[:, 1:] >= key[:, :-1]).all())
    # the padding last, as many as B wrote; draw order within a key
    assert torch.equal(pad.sum(1), (ridx == prm.n_bits).sum(1))
    for e in range(0, 300, 37):
        for b in range(32 // sw):
            row = ridx[e][(ridx[e] != prm.n_bits) & (ridx[e].long() % (32 // sw) == b)]
            assert torch.equal(got[e][~pad[e] & (key[e] == b)], row)
    if prm is INT32:  # 130 taken rows and the zero row twice
        assert bool((pad.sum(1) >= 2).all())


@pytest.mark.parametrize("kp", [16, 32, 128, 132, 260])
@pytest.mark.parametrize("sw", [1, 2])
@pytest.mark.parametrize("staggered", [True, False])
def test_consumer_walk_reads_every_position_once(kp, sw, staggered):
    """At int16 widths (kp a multiple of 8) and int32 ones (of 4, so an odd
    number of quads too), the two threads of each edge of a lookup group
    read each of the row's positions exactly once, four a quad."""
    walk = sigma_fused.consumer_walk(kp, sw, staggered)
    assert walk.shape == (16 // sw, 2, 4 * ((kp // 4 + 1) // 2))
    for j in range(16 // sw):
        got = walk[j][walk[j] >= 0]
        assert torch.equal(torch.sort(got).values, torch.arange(kp)), (j, kp, sw)
        starts = walk[j, :, ::4]
        assert bool((starts[starts >= 0] % 4 == 0).all())


@pytest.mark.parametrize("sw, gain", [(1, 0.9), (2, 0.8)])
def test_staggered_walk_starts_a_group_on_distinct_keys(sw, gain):
    """At default Params, with every key holding kp / keys rows, the lanes
    of a lookup group sit on distinct bank keys at every lookup; on random
    rows the bank order and the walk cost fewer wavefronts than the draw
    order and the plain walk."""
    kp, keys = sigma_fused._ridx_width(DEFAULT), 32 // sw
    walk = sigma_fused.consumer_walk(kp, sw)
    even = torch.arange(kp) * keys // kp                   # a row of even key counts
    on = even[walk.clamp(min=0)].reshape(-1, walk.shape[2])
    assert all(len(set(on[:, u].tolist())) == keys for u in range(walk.shape[2]))
    rng = np.random.default_rng(7)
    rows = _padded_ridx(DEFAULT, 512, rng)
    drawn = sigma_fused.lookup_wavefronts(
        rows, sigma_fused.consumer_walk(kp, sw, staggered=False), sw)
    banked = sigma_fused.lookup_wavefronts(
        sigma_fused.bank_order_plain(rows, sw, DEFAULT.n_bits), walk, sw)
    assert 1.0 < banked < gain * drawn < 4.0


def test_wavefronts_count_distinct_entries_a_key():
    walk = sigma_fused.consumer_walk(32, 2)
    same = torch.full((8, 32), 5, dtype=torch.int16)        # one entry: a broadcast
    assert sigma_fused.lookup_wavefronts(same, walk, 2) == 1.0
    key0 = (torch.arange(8 * 32) * 16).reshape(8, 32)       # 16 lanes, 16 entries, key 0
    assert sigma_fused.lookup_wavefronts(key0, walk, 2) == 16.0


@pytest.fixture(scope="module")
def small_keys():
    return tpv.keygen(SMALL, device="cpu")


def test_engine_counts_fused_edges(small_keys, monkeypatch):
    pk, _ = small_keys
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 64, (700, 7), dtype=np.uint64)
    eng = tpv.enable_device(pk, None, "cpu")
    try:
        want = eng.sigma(words)
        assert eng.stats["sigma_edges"] == 700 and eng.stats["sigma_fused_edges"] == 0
        calls = _stub_launcher(monkeypatch)
        monkeypatch.setattr(eng, "SIGMA_CHUNK", 256)
        got = eng.sigma(words)
        assert calls == [256, 256, 188]
        assert eng.stats["sigma_edges"] == 1400 and eng.stats["sigma_fused_edges"] == 700
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    finally:
        tpv.disable_device(pk)


def test_engine_counts_banked_edges(small_keys, monkeypatch):
    """sigma_banked_edges counts what the fused route counts, and nothing
    on B then C."""
    pk, _ = small_keys
    words = np.random.default_rng(6).integers(0, 1 << 64, (300, 7), dtype=np.uint64)
    eng = tpv.enable_device(pk, None, "cpu")
    try:
        eng.sigma(words)
        assert eng.stats["sigma_banked_edges"] == 0
        _stub_launcher(monkeypatch)
        eng.sigma(words)
        eng.sigma(words[:17])
        assert eng.stats["sigma_banked_edges"] == eng.stats["sigma_fused_edges"] == 317
        assert eng.stats["sigma_edges"] == 617
    finally:
        tpv.disable_device(pk)


# "more": launches whose last chunk is cut short (odd E), in half chunks
# (fewer than four super-tiles), one or two chunks (the next chunk's
# messages built for none or one), and ring slots reused many times over
# (more than 4 super-tiles a group); dense Params flag edges for the fallback
@pytest.mark.cuda
@pytest.mark.parametrize("prm, sizes", [
    (DEFAULT, (1, 100, 1000, 4097, 10000, 65537)),
    (SMALL, (1, 255, 257, 5000, 70001)),
    (DENSE, (1, 4096, 70001)),
    (DEFAULT, (3, 2047, 8191, 16385, 131073)),
    (SMALL, (7, 9, 1001, 33333)),
    (DENSE, (9, 17, 4099)),
], ids=["default", "small", "dense", "default-more", "small-more", "dense-more"])
def test_fused_kernel_matches_b_then_c_and_twins_on_card(prm, sizes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    Hx = _table(prm, rng, "cuda")
    assert matrix.fused_engages(prm, Hx)
    for E in sizes:
        lanes = _lanes(E, rng, "cuda")
        sig, fb = sigma_fused.sigma_rows_fused_cuda(prm, Hx, lanes)
        torch.cuda.synchronize()
        ridx, nbit, want_fb = sigma_draws.taken_indices_cuda(prm, lanes)
        assert torch.equal(sig, sigma_xor.sigma_rows_cuda(Hx, ridx, nbit)), E
        assert torch.equal(fb, want_fb), E
        if prm is DENSE:
            assert fb.any()
        if E <= 5000:
            twin = sigma_fused.sigma_rows_fused_plain(prm, Hx.cpu(), lanes.cpu())
            assert torch.equal(sig.cpu(), twin[0]) and torch.equal(fb.cpu(), twin[1]), E


@pytest.mark.cuda
@pytest.mark.parametrize("prm, E", [(DEFAULT, 4096), (DEFAULT, 1), (SMALL, 1000),
                                    (DENSE, 512)], ids=["default", "one", "small", "dense"])
def test_fused_ring_holds_b_rows_in_bank_order_on_card(prm, E):
    """A launch of at most kRing super-tiles leaves every edge's ring row in
    place: it is B's taken rows in bank order (flagged edges included), and
    σ and fb are B then C's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(E)
    Hx, lanes = _table(prm, rng, "cuda"), _lanes(E, rng, "cuda")
    sig, fb, rows = sigma_fused.sigma_rows_fused_ring(prm, Hx, lanes)
    ridx, nbit, want_fb = sigma_draws.taken_indices_cuda(prm, lanes)
    assert torch.equal(sig, sigma_xor.sigma_rows_cuda(Hx, ridx, nbit))
    assert torch.equal(fb, want_fb)
    kp, sw = sigma_fused._ridx_width(prm), Hx.shape[1] // sigma_fused.plan(prm, Hx)[1]
    padded = torch.nn.functional.pad(ridx, (0, kp - ridx.shape[1]), value=prm.n_bits)
    assert torch.equal(rows, sigma_fused.bank_order_plain(padded, sw, prm.n_bits))


@pytest.mark.cuda
def test_fused_wait_totals_on_card():
    """The diagnostic launch returns the same σ and fb as the plain one and
    two wait totals; the consumers always wait for the first super-tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(13)
    Hx, lanes = _table(DEFAULT, rng, "cuda"), _lanes(65536, rng, "cuda")
    sig, fb, (ready_ns, freed_ns) = sigma_fused.sigma_rows_fused_waits(DEFAULT, Hx, lanes)
    want_sig, want_fb = sigma_fused.sigma_rows_fused_cuda(DEFAULT, Hx, lanes)
    assert torch.equal(sig, want_sig) and torch.equal(fb, want_fb)
    assert ready_ns > 0 and freed_ns >= 0
