"""Scalar AES-256-CTR (host oracle + fallback path).

Reference: include/pvac/crypto/lpn.hpp:41-149 (AES-NI implementation).  The
reference's CTR mode is:

- counter block k (16 bytes) = le64(nonce + k) || 0^8  (the __m128i
  ``_mm_set_epi64x(0, nonce)`` stored little-endian, low lane incremented)
- keystream u64 stream: block bytes read as two little-endian u64s, in order
- ``bounded(M)``: rejection sampling with lim = 2^64-1 - ((2^64-1) % M),
  accept strictly x < lim (lpn.hpp:141-148 — note: *strict*, unlike the
  SHA-CTR streams' x <= lim)

This scalar implementation is pure Python (tables built programmatically
from the GF(2^8) definition) and is the bit-exactness oracle for the
bitsliced vector engine in :mod:`.aesv`.
"""
from __future__ import annotations

import struct

U64MAX = (1 << 64) - 1


def _gf_mul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return r


def _build_sbox():
    # inverse table by Fermat (a^254) then affine transform
    sbox = [0] * 256
    for x in range(256):
        inv = 0
        if x:
            inv = x
            # a^254 via square-and-multiply
            acc = 1
            e = 254
            base = x
            while e:
                if e & 1:
                    acc = _gf_mul(acc, base)
                base = _gf_mul(base, base)
                e >>= 1
            inv = acc
        y = inv
        out = 0
        for i in range(8):
            bit = (
                (y >> i) ^ (y >> ((i + 4) % 8)) ^ (y >> ((i + 5) % 8))
                ^ (y >> ((i + 6) % 8)) ^ (y >> ((i + 7) % 8)) ^ (0x63 >> i)
            ) & 1
            out |= bit << i
        sbox[x] = out
    return sbox


SBOX = _build_sbox()
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40]


def expand_key_256(key: bytes) -> list[int]:
    """AES-256 key schedule -> 60 32-bit words (big-endian word convention:
    word = 4 key bytes b0 b1 b2 b3 as (b0<<24)|...)."""
    assert len(key) == 32
    w = [struct.unpack(">I", key[4 * i : 4 * i + 4])[0] for i in range(8)]
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF  # RotWord
            t = (
                (SBOX[(t >> 24) & 0xFF] << 24)
                | (SBOX[(t >> 16) & 0xFF] << 16)
                | (SBOX[(t >> 8) & 0xFF] << 8)
                | SBOX[t & 0xFF]
            )
            t ^= _RCON[i // 8 - 1] << 24
        elif i % 8 == 4:
            t = (
                (SBOX[(t >> 24) & 0xFF] << 24)
                | (SBOX[(t >> 16) & 0xFF] << 16)
                | (SBOX[(t >> 8) & 0xFF] << 8)
                | SBOX[t & 0xFF]
            )
        w.append(w[i - 8] ^ t)
    return w


def _xt(a: int) -> int:
    a <<= 1
    return (a ^ 0x1B) & 0xFF if a & 0x100 else a


def encrypt_block_256(key_words: list[int], block: bytes) -> bytes:
    """AES-256 ECB encrypt of one 16-byte block."""
    s = list(block)

    def ark(rnd):
        for c in range(4):
            w = key_words[4 * rnd + c]
            s[4 * c + 0] ^= (w >> 24) & 0xFF
            s[4 * c + 1] ^= (w >> 16) & 0xFF
            s[4 * c + 2] ^= (w >> 8) & 0xFF
            s[4 * c + 3] ^= w & 0xFF

    def sub_shift():
        t = [SBOX[b] for b in s]
        # ShiftRows: byte (r, c) <- (r, (c + r) % 4); byte index = r + 4c
        for r in range(4):
            for c in range(4):
                s[r + 4 * c] = t[r + 4 * ((c + r) % 4)]

    def mix():
        for c in range(4):
            a = s[4 * c : 4 * c + 4]
            s[4 * c + 0] = _xt(a[0]) ^ _xt(a[1]) ^ a[1] ^ a[2] ^ a[3]
            s[4 * c + 1] = a[0] ^ _xt(a[1]) ^ _xt(a[2]) ^ a[2] ^ a[3]
            s[4 * c + 2] = a[0] ^ a[1] ^ _xt(a[2]) ^ _xt(a[3]) ^ a[3]
            s[4 * c + 3] = _xt(a[0]) ^ a[0] ^ a[1] ^ a[2] ^ _xt(a[3])

    ark(0)
    for rnd in range(1, 14):
        sub_shift()
        mix()
        ark(rnd)
    sub_shift()
    ark(14)
    return bytes(s)


class AesCtr256:
    """Mirror of the reference AesCtr256 (lpn.hpp:41-149), including the
    buffered-half-block next_u64/fill_u64 interaction."""

    def __init__(self, key: bytes, nonce: int):
        self.kw = expand_key_256(key)
        self.ctr = nonce & U64MAX
        self.buf: tuple[int, int] | None = None  # (unused second u64)

    def _next_block(self) -> tuple[int, int]:
        pt = struct.pack("<QQ", self.ctr, 0)
        self.ctr = (self.ctr + 1) & U64MAX
        ct = encrypt_block_256(self.kw, pt)
        return struct.unpack("<QQ", ct)

    def next_u64(self) -> int:
        if self.buf is not None:
            x = self.buf[0]
            self.buf = None
            return x
        a, b = self._next_block()
        self.buf = (b,)
        return a

    def fill_u64(self, n: int) -> list[int]:
        out = []
        if self.buf is not None and n > 0:
            out.append(self.buf[0])
            self.buf = None
        while len(out) + 1 < n:
            a, b = self._next_block()
            out.append(a)
            out.append(b)
        if len(out) < n:
            a, b = self._next_block()
            out.append(a)
            self.buf = (b,)
        return out

    def bounded(self, M: int) -> int:
        if M <= 1:
            return 0
        lim = U64MAX - (U64MAX % M)
        while True:
            x = self.next_u64()
            if x < lim:  # strict — lpn.hpp:146
                return x % M
