"""Packed GF(2) bit vectors (reference: include/pvac/core/bitvec.hpp).

A batch of m-bit vectors is an array [..., W] of uint32 words, little-endian
bit order (bit i lives in word i // 32 at position i % 32).  This is
bit-compatible with the reference's little-endian uint64 word layout: u64
word j == u32 words 2j (low) and 2j+1 (high).  Host-side (numpy) helpers
used by the wire formats.
"""
from __future__ import annotations

import numpy as np

U32 = np.uint32


def from_u64_words(w64) -> np.ndarray:
    """uint64 word array [..., W64] -> uint32 word array [..., 2*W64]."""
    w64 = np.asarray(w64, dtype=np.uint64)
    lo = (w64 & np.uint64(0xFFFFFFFF)).astype(U32)
    hi = (w64 >> np.uint64(32)).astype(U32)
    out = np.stack([lo, hi], axis=-1)
    return out.reshape(*w64.shape[:-1], w64.shape[-1] * 2)


def to_u64_words(w32) -> np.ndarray:
    """uint32 word array [..., 2*W64] -> uint64 word array [..., W64]."""
    w32 = np.asarray(w32, dtype=np.uint32)
    if w32.shape[-1] % 2:
        raise ValueError("odd number of u32 words")
    pairs = w32.reshape(*w32.shape[:-1], w32.shape[-1] // 2, 2).astype(np.uint64)
    return pairs[..., 0] | (pairs[..., 1] << np.uint64(32))


def popcount32(x: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint32 array (SWAR)."""
    x = np.asarray(x, dtype=U32)
    x = x - ((x >> U32(1)) & U32(0x55555555))
    x = (x & U32(0x33333333)) + ((x >> U32(2)) & U32(0x33333333))
    x = (x + (x >> U32(4))) & U32(0x0F0F0F0F)
    return (x * U32(0x01010101)) >> U32(24)


def popcnt(v: np.ndarray) -> np.ndarray:
    """Total popcount over the word axis (reference BitVec::popcnt)."""
    return popcount32(v).sum(axis=-1)
