"""SHA-256: host digests, the static message layout, and a torch
compression function.

Reference: include/pvac/core/hash.hpp.

- Scalar byte-level SHA-256 uses hashlib (identical function).
- :class:`MsgLayout` describes the one message shape every SHA-256-CTR
  generator of the scheme hashes: a constant label followed by u64 fields
  (crypto/matrix.hpp:15-92, crypto/lpn.hpp:166-192).
- :func:`sha256_compress` runs many independent compressions as int64
  tensor ops (u32 values, see core/bits.py).  The plain twins of the σ
  draw kernel (kernels/sigma_draws.cu) and of the PRF key-derivation
  kernel (kernels/prf_keys.cu) chain it.
- :class:`Shake256` and :class:`XofShake`: the reference's SHAKE256 sponge
  and labeled XOF, in plain Python on the host.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from .bits import M32

U32 = np.uint32
U8 = np.uint8

SHA_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

SHA_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


# ---------------------------------------------------------------------------
# torch compression (u32 values in int64 tensors)
# ---------------------------------------------------------------------------

def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def sha256_init_state(batch_shape, device=None) -> torch.Tensor:
    h0 = torch.tensor(SHA_H0, dtype=torch.int64, device=device)
    return h0.expand(*batch_shape, 8)


def sha256_compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression per lane.

    state: [..., 8] int64 u32 values; block: [..., 16] int64 big-endian
    message words.  Returns the new [..., 8] state."""
    w = [block[..., i] for i in range(16)]
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M32)

    a, b, c, d, e, f, g, h = (state[..., i] for i in range(8))
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = (h + S1 + ch + SHA_K[i] + w[i]) & M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = S0 + maj
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32, c, b, a,
                                  (t1 + t2) & M32)
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=-1)) & M32


def bswap32(x: torch.Tensor) -> torch.Tensor:
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def digest_words_to_le_u64_pairs(state: torch.Tensor) -> torch.Tensor:
    """Map a final [..., 8] state to the 4 little-endian u64s the reference
    reads out of the 32-byte digest buffer (load_le64(buf + 8j)).

    Digest bytes are BE(h0)..BE(h7); a little-endian u64 load of bytes
    8j..8j+7 therefore equals (bswap32(h[2j]), bswap32(h[2j+1])) as
    (lo32, hi32).  Returns [..., 4, 2] int64."""
    sw = bswap32(state)
    return torch.stack([sw[..., 0::2], sw[..., 1::2]], dim=-1)


# ---------------------------------------------------------------------------
# static message layout
# ---------------------------------------------------------------------------

class MsgLayout:
    """Static layout of a SHA-256 message whose bytes are (constant prefix ||
    k little-endian u64 fields), padded to full blocks.

    Because the layout is static, each big-endian message u32 word is a
    fixed function of the prefix constants and of specific bytes of the u64
    fields, so message blocks can be assembled with pure vector ops."""

    def __init__(self, prefix: bytes, n_u64_fields: int):
        self.prefix = prefix
        self.n_fields = n_u64_fields
        self.msg_len = len(prefix) + 8 * n_u64_fields
        total = self.msg_len + 1 + 8  # 0x80 pad byte + 64-bit length
        self.n_blocks = (total + 63) // 64
        tmpl = bytearray(self.n_blocks * 64)
        tmpl[: len(prefix)] = prefix
        tmpl[self.msg_len] = 0x80
        tmpl[-8:] = struct.pack(">Q", self.msg_len * 8)
        self.template = np.frombuffer(bytes(tmpl), dtype=U8).copy()

    def template_words(self) -> np.ndarray:
        """The message template as [n_blocks*16] big-endian u32 words."""
        return (
            (self.template[0::4].astype(np.uint32) << 24)
            | (self.template[1::4].astype(np.uint32) << 16)
            | (self.template[2::4].astype(np.uint32) << 8)
            | (self.template[3::4].astype(np.uint32))
        )

    def build_blocks(self, fields: torch.Tensor) -> torch.Tensor:
        """fields: [..., n_fields, 2] int64 (lo32, hi32) of each u64 field.
        Returns [..., n_blocks, 16] int64 big-endian message words."""
        batch = fields.shape[:-2]
        nb = self.n_blocks
        tmpl = torch.from_numpy(self.template_words().astype(np.int64)).to(fields.device)
        words = tmpl.expand(*batch, nb * 16).clone()
        for f in range(self.n_fields):
            off = len(self.prefix) + 8 * f
            for j in range(8):
                src = fields[..., f, 0] if j < 4 else fields[..., f, 1]
                byte = (src >> (8 * (j % 4))) & 0xFF
                pos = off + j
                w, sh = pos // 4, (3 - pos % 4) * 8
                words[..., w] = (words[..., w] & ~(0xFF << sh)) | (byte << sh)
        return words.reshape(*batch, nb, 16)


# ---------------------------------------------------------------------------
# SHAKE256 (host-side, pure Python; dead code in the reference scheme but
# part of its API surface — hash.hpp:193-384)
# ---------------------------------------------------------------------------

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_KECCAK_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_M64 = (1 << 64) - 1


def _rotl64(x, r):
    if r == 0:
        return x
    return ((x << r) | (x >> (64 - r))) & _M64


class Shake256:
    """SHAKE256 sponge (rate 136), matching hash.hpp:193-348."""

    def __init__(self):
        self.st = [0] * 25
        self.rate = 136
        self.pos = 0
        self.squeezing = False

    def _keccakf(self):
        st = self.st
        for rnd in range(24):
            C = [st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20] for x in range(5)]
            D = [C[(x + 4) % 5] ^ _rotl64(C[(x + 1) % 5], 1) for x in range(5)]
            for x in range(5):
                for y in range(5):
                    st[x + 5 * y] ^= D[x]
            B = [0] * 25
            for x in range(5):
                for y in range(5):
                    X, Y = y, (2 * x + 3 * y) % 5
                    B[X + 5 * Y] = _rotl64(st[x + 5 * y], _KECCAK_ROT[x][y])
            for x in range(5):
                for y in range(5):
                    st[x + 5 * y] = B[x + 5 * y] ^ (
                        (~B[(x + 1) % 5 + 5 * y] & _M64) & B[(x + 2) % 5 + 5 * y]
                    )
            st[0] ^= _KECCAK_RC[rnd]

    def absorb(self, data: bytes) -> None:
        assert not self.squeezing
        for byte in data:
            if self.pos == self.rate:
                self._keccakf()
                self.pos = 0
            w, sh = self.pos // 8, (self.pos % 8) * 8
            self.st[w] ^= byte << sh
            self.pos += 1

    def _pad(self) -> None:
        # absorb permutes a full block only when the next byte arrives, so
        # an input of a whole number of blocks leaves one to permute here
        # (FIPS 202; without it such inputs hash wrong)
        if self.pos == self.rate:
            self._keccakf()
            self.pos = 0
        w, sh = self.pos // 8, (self.pos % 8) * 8
        self.st[w] ^= 0x1F << sh
        idx = self.rate - 1
        self.st[idx // 8] ^= 0x80 << ((idx % 8) * 8)
        self._keccakf()
        self.pos = 0
        self.squeezing = True

    def squeeze(self, n: int) -> bytes:
        if not self.squeezing:
            self._pad()
        out = bytearray()
        while len(out) < n:
            if self.pos == self.rate:
                self._keccakf()
                self.pos = 0
            w, sh = self.pos // 8, (self.pos % 8) * 8
            out.append((self.st[w] >> sh) & 0xFF)
            self.pos += 1
        return bytes(out)

    def next_u64(self) -> int:
        return struct.unpack("<Q", self.squeeze(8))[0]


class XofShake:
    """Labeled XOF with rejection-sampled bounded() (hash.hpp:350-384)."""

    def __init__(self, label: str, seed_u64s):
        self.sh = Shake256()
        self.sh.absorb(label.encode())
        for w in seed_u64s:
            self.sh.absorb(struct.pack("<Q", w & _M64))
        self.sh._pad()

    def take_u64(self) -> int:
        return self.sh.next_u64()

    def bounded(self, M: int) -> int:
        if M <= 1:
            return 0
        lim = _M64 - (_M64 % M)
        while True:
            x = self.take_u64()
            if x <= lim:
                return x % M
