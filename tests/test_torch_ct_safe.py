"""The port's copy of the constant-time toolkit (core/ct_safe.py): the
tests of tests/test_ct_safe.py.  Constant-time toolkit semantics (port of tests/test_ct.cpp's randomized
compare-vs-native-op sections) and the timing-uniformity shape of
tests/test_ct_safe.cpp."""
import random
import time

import numpy as np
import pytest

from pvac_hfhe_cppbyv_tpu_torch.core import ct_safe as ct
from pvac_hfhe_cppbyv_tpu_torch.core import field as F

M64 = (1 << 64) - 1


def test_masks_and_selects_randomized():
    rng = random.Random(0xC7)
    for _ in range(1000):
        a = rng.getrandbits(64)
        b = rng.getrandbits(64)
        assert ct.is_zero(a) == (M64 if a == 0 else 0)
        assert ct.eq_mask(a, b) == (M64 if a == b else 0)
        assert ct.lt_mask(a, b) == (M64 if a < b else 0)
        m = M64 if rng.random() < 0.5 else 0
        assert ct.select(m, a, b) == (a if m else b)
        x, y = ct.cswap(m, a, b)
        assert (x, y) == ((b, a) if m else (a, b))
        assert ct.sat_sub(a, b) == max(0, a - b) % (1 << 64)
        r = rng.randrange(1, 64)
        assert ct.rotl(a, r) == ((a << r) | (a >> (64 - r))) & M64
        assert ct.rotr(ct.rotl(a, r), r) == a


def test_zero_edge_cases():
    assert ct.is_zero(0) == M64
    assert ct.is_zero(1) == 0
    assert ct.is_zero(M64) == 0
    assert ct.lt_mask(0, 0) == 0
    assert ct.lt_mask(0, 1) == M64
    assert ct.lt_mask(M64, 0) == 0


def test_fp_variants():
    rng = random.Random(5)
    for _ in range(200):
        a = rng.randrange(F.P)
        b = rng.randrange(F.P)
        assert ct.fp_eq(a, a)
        assert ct.fp_eq(a, b) == (a == b)
        assert ct.fp_is_zero_mask(0) == M64
        assert ct.fp_select(M64, a, b) == a
        assert ct.fp_select(0, a, b) == b
        x, y = ct.fp_cswap(M64, a, b)
        assert (x, y) == (b, a)


def test_table_ops():
    table = [7, 8, 9, 10]
    for i in range(4):
        assert ct.lookup(table, i) == table[i]
    ct.store(table, 2, 99)
    assert table == [7, 8, 99, 10]


def test_mem_ops():
    assert ct.memeq(b"abc", b"abc")
    assert not ct.memeq(b"abc", b"abd")
    dst = bytearray(b"xxxx")
    ct.memcpy_if(0xFF, dst, b"abcd")
    assert dst == b"abcd"
    ct.memcpy_if(0, dst, b"zzzz")
    assert dst == b"abcd"
    ct.memzero_if(0xFF, dst)
    assert dst == b"\x00" * 4


def test_bv_select_cswap():
    a = np.arange(8, dtype=np.uint32)
    b = a + np.uint32(100)
    assert np.array_equal(ct.bv_select(0xFFFFFFFF, a, b), a)
    assert np.array_equal(ct.bv_select(0, a, b), b)
    x, y = ct.bv_cswap(0xFFFFFFFF, a, b)
    assert np.array_equal(x, b) and np.array_equal(y, a)


@pytest.mark.slow
def test_timing_uniformity_field_ops():
    """test_ct_safe.cpp:132-171: hot (fixed) vs random input timing ratio
    must stay below 3.0 for the batched field kernels."""
    from pvac_hfhe_cppbyv_tpu_torch.core import fieldv as FV

    rng = np.random.default_rng(0)
    hot = FV.from_ints([(1 << 126) - 3] * 4096)
    rand_vals = FV.from_ints(
        [int.from_bytes(rng.bytes(15), "little") for _ in range(4096)]
    )

    def t(f, a):
        best = 1e9
        for _ in range(5):
            t0 = time.perf_counter()
            f(a, a)
            best = min(best, time.perf_counter() - t0)
        return best

    for op in (FV.mul, FV.add):
        th = t(op, hot)
        tr = t(op, rand_vals)
        ratio = max(th, tr) / max(min(th, tr), 1e-9)
        assert ratio < 3.0, f"{op.__name__}: {ratio}"
