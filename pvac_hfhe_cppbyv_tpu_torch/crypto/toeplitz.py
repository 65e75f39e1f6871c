"""GF(2) Toeplitz extractor (reference: include/pvac/crypto/toeplitz.hpp).

The reference computes a full carry-less convolution of the t-bit LPN output
with a (t+127)-bit pseudorandom top row, then keeps bits 0..126
(toeplitz.hpp:121-190).  Bit k of a GF(2) convolution depends only on
operand bits 0..k, so the 127 output bits depend only on the first 127 bits
of each operand.  The batched path therefore convolves two 127-bit
operands (:func:`conv127`, torch); the scalar path keeps the reference's
full-width shape for the exact fallback.
"""
from __future__ import annotations

import torch

from ..core.bits import M32


def gf2_conv_scalar(a_words: list[int], b_words: list[int]) -> list[int]:
    """Carry-less product of two bit strings given as u64 word lists
    (toeplitz.hpp:22-48).  Returns len(a)+len(b) u64 words."""
    A = 0
    for i, w in enumerate(a_words):
        A |= (w & 0xFFFFFFFFFFFFFFFF) << (64 * i)
    B = 0
    for i, w in enumerate(b_words):
        B |= (w & 0xFFFFFFFFFFFFFFFF) << (64 * i)
    R = 0
    while A:
        low = A & -A
        R ^= B << (low.bit_length() - 1)
        A ^= low
    n = len(a_words) + len(b_words)
    return [(R >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n)]


def toep_127_scalar(top_words: list[int], y_words: list[int]) -> tuple[int, int]:
    """toep_127 (toeplitz.hpp:121-140): conv(y, top), keep bits 0..126 as
    (lo, hi) u64 pair."""
    r = gf2_conv_scalar(y_words, top_words)
    val = (r[0] | (r[1] << 64)) & ((1 << 127) - 1)
    return val & 0xFFFFFFFFFFFFFFFF, val >> 64


def conv127(y4: torch.Tensor, top4: torch.Tensor) -> torch.Tensor:
    """Batched 127-bit GF(2) convolution, truncated to 127 output bits.

    y4, top4: [..., 4] int64 u32 limbs (bits 0..126 significant).  Returns
    [..., 4] with bits 0..126 of conv(y, top): 127 shift-XOR steps, each
    XORing top << a under the mask of y's bit a (toeplitz.py:68-97 of the
    JAX package)."""
    acc = [torch.zeros_like(y4[..., 0]) for _ in range(4)]
    t = [top4[..., k] for k in range(4)]
    for a in range(127):
        w, s = divmod(a, 32)
        mask = -((y4[..., w] >> s) & 1) & M32
        for k in range(w, 4):
            sh = (t[k - w] << s) & M32
            if s and k - w - 1 >= 0:
                sh = sh | (t[k - w - 1] >> (32 - s))
            acc[k] = acc[k] ^ (sh & mask)
    acc[3] = acc[3] & 0x7FFFFFFF
    return torch.stack(acc, dim=-1)
