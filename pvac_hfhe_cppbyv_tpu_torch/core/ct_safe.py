"""Constant-time-style toolkit (reference: include/pvac/core/ct_safe.hpp).

The same API surface as the reference (masks, selects, swaps,
field/bitvec variants, masked memory ops), for host-side code and for the
reference's test_ct.cpp semantics tests.

All scalar helpers operate on Python ints confined to the stated width and
are written branch-free (mask arithmetic), mirroring ct_safe.hpp:61-346.
"""
from __future__ import annotations

import hmac

import numpy as np

_M64 = (1 << 64) - 1


def _mask_width(width: int) -> int:
    return (1 << width) - 1


def is_zero(x: int, width: int = 64) -> int:
    """All-ones mask iff x == 0 (ct::is_zero)."""
    m = _mask_width(width)
    x &= m
    t = (x | (-x & m)) >> (width - 1)
    return (t ^ 1) * m & m


def is_nonzero(x: int, width: int = 64) -> int:
    m = _mask_width(width)
    return is_zero(x, width) ^ m


def eq_mask(a: int, b: int, width: int = 64) -> int:
    """All-ones mask iff a == b."""
    return is_zero((a ^ b) & _mask_width(width), width)


def lt_mask(a: int, b: int, width: int = 64) -> int:
    """All-ones mask iff a < b (unsigned)."""
    m = _mask_width(width)
    d = (a - b) & ((1 << (width + 1)) - 1)
    borrow = (d >> width) & 1
    return borrow * m


def select(mask: int, a: int, b: int, width: int = 64) -> int:
    """mask all-ones -> a, else b."""
    m = _mask_width(width)
    return ((a & mask) | (b & ~mask & m)) & m


def cswap(mask: int, a: int, b: int, width: int = 64) -> tuple[int, int]:
    """Swap iff mask is all-ones."""
    m = _mask_width(width)
    t = (a ^ b) & mask & m
    return a ^ t, b ^ t


def sat_sub(a: int, b: int, width: int = 64) -> int:
    """Saturating a - b (floor at 0)."""
    m = _mask_width(width)
    d = (a - b) & m
    return select(lt_mask(a, b, width), 0, d, width)


def rotl(x: int, r: int, width: int = 64) -> int:
    m = _mask_width(width)
    r %= width
    return ((x << r) | ((x & m) >> (width - r))) & m


def rotr(x: int, r: int, width: int = 64) -> int:
    return rotl(x, width - (r % width), width)


# ---- field-element variants (ct_safe.hpp:221-288) ----

def fp_is_zero_mask(x: int) -> int:
    lo, hi = x & _M64, (x >> 64) & _M64
    return is_zero(lo | hi, 64)


def fp_is_nonzero(x: int) -> bool:
    return x != 0


def fp_is_one(x: int) -> bool:
    return x == 1


def fp_eq(a: int, b: int) -> bool:
    """Branch-free field compare (both canonical)."""
    alo, ahi = a & _M64, (a >> 64) & _M64
    blo, bhi = b & _M64, (b >> 64) & _M64
    return is_zero((alo ^ blo) | (ahi ^ bhi), 64) == _M64


def fp_select(mask: int, a: int, b: int) -> int:
    alo, ahi = a & _M64, a >> 64
    blo, bhi = b & _M64, b >> 64
    return select(mask, alo, blo, 64) | (select(mask, ahi, bhi, 64) << 64)


def fp_cswap(mask: int, a: int, b: int) -> tuple[int, int]:
    alo, blo = cswap(mask, a & _M64, b & _M64, 64)
    ahi, bhi = cswap(mask, a >> 64, b >> 64, 64)
    return alo | (ahi << 64), blo | (bhi << 64)


# ---- bit-vector variants ----

def bv_select(mask: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Select whole packed bit-vectors under a 0/all-ones mask."""
    m = np.uint32(mask & 0xFFFFFFFF)
    return (a & m) | (b & ~m)


def bv_cswap(mask: int, a: np.ndarray, b: np.ndarray):
    m = np.uint32(mask & 0xFFFFFFFF)
    t = (a ^ b) & m
    return a ^ t, b ^ t


# ---- masked table / memory ops (ct_safe.hpp:290-345) ----

def lookup(table, idx: int) -> int:
    """Scan-all-entries table lookup (no data-dependent addressing)."""
    out = 0
    for i, v in enumerate(table):
        out |= v & eq_mask(i, idx, 64)
    return out


def store(table: list, idx: int, val: int, width: int = 64) -> None:
    for i in range(len(table)):
        m = eq_mask(i, idx, 64)
        table[i] = select(m, val, table[i], width)


def memeq(a: bytes, b: bytes) -> bool:
    """Constant-time byte-string compare."""
    return hmac.compare_digest(a, b)


def memcpy_if(mask: int, dst: bytearray, src: bytes) -> None:
    m = mask & 0xFF
    for i in range(len(dst)):
        dst[i] = (src[i] & m) | (dst[i] & ~m & 0xFF)


def memset_if(mask: int, dst: bytearray, val: int) -> None:
    m = mask & 0xFF
    for i in range(len(dst)):
        dst[i] = (val & m) | (dst[i] & ~m & 0xFF)


def memzero_if(mask: int, dst: bytearray) -> None:
    memset_if(mask, dst, 0)
