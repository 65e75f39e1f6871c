"""Scalar field arithmetic over F_p, p = 2^127 - 1.

Host-side scalar path (reference: include/pvac/core/field.hpp:50-273).  Field
elements are canonical Python ints in [0, p); the (lo, hi) u64-pair view used
by the wire formats is provided by :func:`fp_from_words` / :func:`fp_to_words`.
The batched device path lives in :mod:`.fieldv` (4x32-bit limb vectors).

Python's arbitrary-precision ints make the scalar path trivially correct; it
is used for layer bookkeeping, key generation glue and test mirrors, never in
per-edge hot loops.
"""
from __future__ import annotations

from .random import csprng_u64

P = (1 << 127) - 1
MASK63 = (1 << 63) - 1
MASK64 = (1 << 64) - 1


def fp_from_u64(x: int) -> int:
    return x % P if x >= P else x


def fp_from_words(lo: int, hi: int) -> int:
    """Canonicalize an arbitrary 128-bit (lo, hi) pair into [0, p).

    Mirrors fp_from_words (core/field.hpp:26-48): fold bit 127, then a single
    conditional subtract.  Inputs beyond 128 bits are reduced mod 2^128 first
    (the reference takes u64 words, so this cannot arise there).
    """
    x = ((hi & MASK64) << 64) | (lo & MASK64)
    x = (x & P) + (x >> 127)
    if x >= P:
        x -= P
    return x


def fp_to_words(x: int) -> tuple[int, int]:
    return x & MASK64, (x >> 64) & MASK64


def fp_add(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def fp_neg(a: int) -> int:
    return P - a if a else 0


def fp_sub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def fp_mul(a: int, b: int) -> int:
    z = a * b
    # Mersenne fold (core/field.hpp:179-207): two folds + conditional subtract.
    z = (z & P) + (z >> 127)
    z = (z & P) + (z >> 127)
    return z - P if z >= P else z


def fp_pow(a: int, e: int) -> int:
    return pow(a, e, P)


def fp_inv(a: int) -> int:
    """Inverse by Fermat: a^(p-2) mod p (reference uses a fixed-window chain,
    core/field.hpp:229-269; the result is identical)."""
    return pow(a, P - 2, P)


def rand_fp_nonzero() -> int:
    """Uniform nonzero field element from the OS CSPRNG
    (core/types.hpp:145-155)."""
    while True:
        lo = csprng_u64()
        hi = csprng_u64() & MASK63
        x = fp_from_words(lo, hi)
        if x:
            return x
