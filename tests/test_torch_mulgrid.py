"""The port's dense-grid ct_mul (mulgrid.py) against brute force, the JAX
package's MulGrid and the host aggregation.

The grid must give the reference's O(|A|*|B|) bucket sums
(include/pvac/ops/arithmetic.hpp:72-101) bit for bit, for any layer
counts, duplicate slots and cancelling weights.  Everything is exact
(tolerance 0: bucket coordinates and field limbs)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
from pvac_hfhe_cppbyv_tpu.core import field as jF
from pvac_hfhe_cppbyv_tpu.core import fieldv as jFV
from pvac_hfhe_cppbyv_tpu.parallel.mulgrid import MulGrid as JMulGrid
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.mulgrid import KPAD, MulGrid
from pvac_hfhe_cppbyv_tpu_torch.ops import arithmetic as arith

torch.set_num_threads(2)

P = (1 << 127) - 1


def _carry(pk, sk):
    pkf = dict(prm=dataclasses.asdict(pk.prm), canon_tag=pk.canon_tag, H=pk.H,
               ubk_perm=pk.ubk.perm, ubk_inv=pk.ubk.inv, H_digest=pk.H_digest,
               omega_B=pk.omega_B, powg_B=pk.powg_B)
    return tpv.keys_from_numpy(pkf, dict(prf_k=sk.prf_k, lpn_s_bits=sk.lpn_s_bits), device="cpu")


@pytest.fixture(scope="module")
def keys():
    jpk, jsk = jpv.keygen(jpv.small_test_params())
    return jpk, jsk, *_carry(jpk, jsk)


def _rand_w(rng, n):
    w = rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64).astype(np.uint32)
    w[:, 3] &= 0x7FFFFFFF
    return w


def _prm(B):
    return type("Prm", (), {"B": B})()


def test_mulgrid_vs_bruteforce():
    """B = 23, raw edges with repeated slots pre-aggregated as
    _stage_device does, against the pair-by-pair field sums."""
    B = 23
    rng = np.random.default_rng(7)
    LA, LB, nA, nB = 3, 5, 40, 60

    def edges(E, L):
        return (rng.integers(0, L, E), rng.integers(0, B, E), rng.integers(0, 2, E),
                _rand_w(rng, E))

    la_, ia_, ca_, wa_ = edges(nA, LA)
    lb_, ib_, cb_, wb_ = edges(nB, LB)

    def agg(lid, idx, ch, w):
        key = (lid * 2 + ch) * B + idx
        uniq, inv = np.unique(key, return_inverse=True)
        acc = np.zeros((len(uniq), 4), dtype=np.uint64)
        np.add.at(acc, inv, w.astype(np.uint64))
        return uniq, jFV.canon_u64_limbs(acc)

    la, lb, c, s, w = MulGrid(_prm(B), "cpu").start(
        *agg(la_, ia_, ca_, wa_), LA, *agg(lb_, ib_, cb_, wb_), LB)()

    want = {}
    for a in range(nA):
        for b in range(nB):
            k = (int(la_[a]), int(lb_[b]), (int(ia_[a]) + int(ib_[b])) % B,
                 int(ca_[a] != cb_[b]))
            wa = jFV.to_ints(wa_[a : a + 1])[0]
            wb = jFV.to_ints(wb_[b : b + 1])[0]
            want[k] = jF.fp_add(want.get(k, 0), jF.fp_mul(wa, wb))
    want = {k: v for k, v in want.items() if v}
    got = {(int(x), int(y), int(z), int(t)): v
           for x, y, z, t, v in zip(la, lb, c, s, jFV.to_ints(w))}
    assert got == want


@pytest.fixture(scope="module")
def jax_grid():
    """One JAX MulGrid, so both cases below share its compiled program."""
    return JMulGrid(_prm(337), jax.devices("cpu")[0])


@pytest.mark.parametrize("case", ["random", "full_p_minus_1"])
def test_mulgrid_matches_jax(jax_grid, case):
    """B = 337: the port's grid and the JAX MulGrid on the CPU give the same
    nonzero buckets, in the same (la, lb, c, s) order, with the same limbs.
    "full_p_minus_1" occupies every slot of a 4 x 4 layer grid with weight
    p - 1, whose 7-bit digits are 126, 127 (x17) and 1: the digit products
    and their sums reach their maximum."""
    B, L = 337, 4
    rng = np.random.default_rng(11)
    if case == "random":
        sA = np.sort(rng.choice(L * 2 * B, 2100, replace=False))
        sB = np.sort(rng.choice(L * 2 * B, 2500, replace=False))
        wA, wB = _rand_w(rng, len(sA)), _rand_w(rng, len(sB))
        wA[:5] = 0  # zero weights in occupied slots
    else:
        sA = sB = np.arange(L * 2 * B)
        wA = wB = np.tile(np.array([0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF],
                                   dtype=np.uint32), (len(sA), 1))
    ow, nz = jax_grid.start(sA.astype(np.int32), wA, L, sB.astype(np.int32), wB, L)()
    la, lb, c, s, w = MulGrid(_prm(B), "cpu").start(sA, wA, L, sB, wB, L)()
    want = np.nonzero(nz)
    assert len(want[0]) > 0
    for g, x in zip((la, lb, c, s), want):
        assert np.array_equal(g, x)
    assert w.dtype == np.uint32 and np.array_equal(w, ow[want])


def test_digit_product_exact_at_all_127():
    """The grid's int8 digit product at its largest sums: all-127 digits
    over the padded contraction, against an int64 matrix product."""
    a = torch.full((152, 337 + (-337) % KPAD), 127, dtype=torch.int8)
    a[:, 337:] = 0
    b = torch.full((64, a.shape[1]), 127, dtype=torch.int8)
    got = torch._int_mm(a, b.t())
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ b.long().t())
    assert int(got.max()) == 337 * 127 * 127


def _canon_order(s):
    key = np.lexsort((s["out_ch"], s["out_idx"], s["out_lid"]))
    return [s[k][key] for k in ("out_lid", "out_idx", "out_ch", "out_w")]


def test_stage_device_matches_host(keys, monkeypatch):
    """_stage_device on a CPU engine against _ct_mul_stage_host: the fresh
    product (one grid block) equal column by column in order; its square,
    blocked at MULGRID_LBLOCK = 2 (4 occupied layers a side, 2 x 2
    blocks), equal as an edge set."""
    jpk, jsk, pk, sk = keys
    a, b = tpv.enc_value_batch(pk, sk, [123, 456])
    eng = tpv.enable_device(pk, sk, "cpu")
    try:
        layers, base = arith._mul_layers(pk, a, b)
        dev = arith._stage_device(pk, eng, a, b, layers, base)()
        host = arith._ct_mul_stage_host(pk, layers, base, a, b)
        for k in ("out_lid", "out_idx", "out_ch", "out_w"):
            assert dev[k].dtype == host[k].dtype and np.array_equal(dev[k], host[k]), k
        prod = tpv.ct_mul(pk, a, b)
        monkeypatch.setattr(arith, "MULGRID_LBLOCK", 2)
        blocks0 = eng.stats["mulgrid_blocks"]
        layers, base = arith._mul_layers(pk, prod, prod)
        dev = arith._stage_device(pk, eng, prod, prod, layers, base)()
        assert eng.stats["mulgrid_blocks"] - blocks0 == 4
        host = arith._ct_mul_stage_host(pk, layers, base, prod, prod)
        for g, h in zip(_canon_order(dev), _canon_order(host)):
            assert np.array_equal(g, h)
    finally:
        tpv.disable_device(pk)


def test_grid_product_decrypts_in_both(keys, monkeypatch, tmp_path):
    """ct_mul routed through the grid (a CPU engine, the native aggregator
    ruled out) decrypts through the port and, from .ct bytes, through the
    JAX package, at depth 1 and 2."""
    jpk, jsk, pk, sk = keys
    monkeypatch.setattr(arith, "MULGRID_PAIR_THRESHOLD", 1)
    monkeypatch.setattr(arith, "_native_agg_viable", lambda *a: False)
    a, b = tpv.enc_value_batch(pk, sk, [31337, P - 5])
    eng = tpv.enable_device(pk, sk, "cpu")
    try:
        prod = tpv.ct_mul(pk, a, b)
        sq = tpv.ct_mul(pk, prod, prod)
        assert eng.stats["mulgrid_blocks"] == 2
        got = [tpv.dec_value(pk, sk, prod), tpv.dec_value(pk, sk, sq)]
    finally:
        tpv.disable_device(pk)
    want = [31337 * (P - 5) % P, pow(31337 * (P - 5), 2, P)]
    assert got == want
    tpv.save_cts([prod, sq], str(tmp_path / "grid.ct"))
    assert jpv.dec_value_batch(jpk, jsk, jpv.load_cts(str(tmp_path / "grid.ct"))) == want


@pytest.mark.cuda
def test_grid_on_card_matches_cpu():
    """The grid on the card (torch._int_mm on CUDA) against the same grid
    on the CPU, on a fully occupied 4 x 8 layer grid of random weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, LA, LB = 337, 4, 8
    rng = np.random.default_rng(5)
    sA, sB = np.arange(LA * 2 * B), np.arange(LB * 2 * B)
    wA, wB = _rand_w(rng, len(sA)), _rand_w(rng, len(sB))
    got = MulGrid(_prm(B), "cuda").start(sA, wA, LA, sB, wB, LB)()
    want = MulGrid(_prm(B), "cpu").start(sA, wA, LA, sB, wB, LB)()
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
