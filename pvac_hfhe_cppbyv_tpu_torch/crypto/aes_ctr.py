"""AES-256-CTR keystreams for many lanes, in plain torch.

Counter block b of a lane is le64(nonce + b) || 0^8 (64-bit wrap), and
the keystream of [nblocks, 4] u32 words read as little-endian u64 pairs
is the reference's AesCtr256.fill_u64 stream
(include/pvac/crypto/lpn.hpp:41-149).  This is the value of the JAX
package's aes_fused.aes_ctr_keystream_fused and, from round keys, of
aes_pallas.aes_ctr_keystream_pallas.

These are stages of the kernels' twins, computing the T-table rounds on
int64 u32 values: :func:`aes_ctr_keystream_plain` (raw keys, expanded by
:func:`expand_keys`) is the first stage of kernel A's twin
(crypto/lpn_ybits.py), and :func:`round_keys` followed by
:func:`aes_ctr_keystream_rk_plain` the first stages of kernel E's
(crypto/toep_core.py).  The kernels never write a keystream out.  The
twins are what the CPU tests hold against the JAX package.
"""
from __future__ import annotations

import torch

from ..core.bits import M32, i32_to_u32, u32_to_i32
from .aes import SBOX

_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40)


def _ror(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _bswap(x):
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def _sbox(device):
    return torch.tensor(SBOX, dtype=torch.int64, device=device)


def _tables(device):
    S = _sbox(device)
    s2 = ((S << 1) ^ torch.where((S & 0x80) != 0, 0x1B, 0)) & 0xFF
    t0 = (s2 << 24) | (S << 16) | (S << 8) | (s2 ^ S)
    return S, (t0, _ror(t0, 8), _ror(t0, 16), _ror(t0, 24))


def _sub_word(S, t):
    return ((S[t >> 24] << 24) | (S[(t >> 16) & 0xFF] << 16)
            | (S[(t >> 8) & 0xFF] << 8) | S[t & 0xFF])


def expand_keys(keys: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """[N, 32] uint8 keys -> [N, 60] int64 round-key words (big-endian
    word convention, crypto/aes.expand_key_256)."""
    k = keys.to(torch.int64)
    w = [(k[:, 4 * i] << 24) | (k[:, 4 * i + 1] << 16)
         | (k[:, 4 * i + 2] << 8) | k[:, 4 * i + 3] for i in range(8)]
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = _sub_word(S, ((t << 8) | (t >> 24)) & M32) ^ (_RCON[i // 8 - 1] << 24)
        elif i % 8 == 4:
            t = _sub_word(S, t)
        w.append(w[i - 8] ^ t)
    return torch.stack(w, dim=1)


def round_keys(keys: torch.Tensor) -> torch.Tensor:
    """[N, 32] uint8 keys -> [N, 60] int32 round keys, expanded by torch
    ops on the keys' device."""
    return u32_to_i32(expand_keys(keys, _sbox(keys.device)))


def aes_ctr_keystream_rk_plain(rk: torch.Tensor, nlo: torch.Tensor,
                               nhi: torch.Tensor, nblocks: int) -> torch.Tensor:
    """rk [N, 60] int32 round-key words, nlo/nhi [N] int32 (u32 halves of
    the 64-bit nonce) -> words [N, nblocks, 4] int32 (u32 bit patterns)."""
    S, (T0, T1, T2, T3) = _tables(rk.device)
    rk = i32_to_u32(rk)
    b = torch.arange(nblocks, dtype=torch.int64, device=rk.device)[None, :]
    clo = i32_to_u32(nlo)[:, None] + b
    chi = (i32_to_u32(nhi)[:, None] + (clo >> 32)) & M32
    clo = clo & M32
    s0 = _bswap(clo) ^ rk[:, 0:1]
    s1 = _bswap(chi) ^ rk[:, 1:2]
    s2 = rk[:, 2:3].expand_as(s0)
    s3 = rk[:, 3:4].expand_as(s0)
    for r in range(1, 14):
        s0, s1, s2, s3 = (
            T0[s0 >> 24] ^ T1[(s1 >> 16) & 0xFF] ^ T2[(s2 >> 8) & 0xFF]
            ^ T3[s3 & 0xFF] ^ rk[:, 4 * r : 4 * r + 1],
            T0[s1 >> 24] ^ T1[(s2 >> 16) & 0xFF] ^ T2[(s3 >> 8) & 0xFF]
            ^ T3[s0 & 0xFF] ^ rk[:, 4 * r + 1 : 4 * r + 2],
            T0[s2 >> 24] ^ T1[(s3 >> 16) & 0xFF] ^ T2[(s0 >> 8) & 0xFF]
            ^ T3[s1 & 0xFF] ^ rk[:, 4 * r + 2 : 4 * r + 3],
            T0[s3 >> 24] ^ T1[(s0 >> 16) & 0xFF] ^ T2[(s1 >> 8) & 0xFF]
            ^ T3[s2 & 0xFF] ^ rk[:, 4 * r + 3 : 4 * r + 4],
        )
    f = [
        _sub_word(S, (s0 & 0xFF000000) | (s1 & 0xFF0000) | (s2 & 0xFF00) | (s3 & 0xFF)),
        _sub_word(S, (s1 & 0xFF000000) | (s2 & 0xFF0000) | (s3 & 0xFF00) | (s0 & 0xFF)),
        _sub_word(S, (s2 & 0xFF000000) | (s3 & 0xFF0000) | (s0 & 0xFF00) | (s1 & 0xFF)),
        _sub_word(S, (s3 & 0xFF000000) | (s0 & 0xFF0000) | (s1 & 0xFF00) | (s2 & 0xFF)),
    ]
    out = torch.stack(
        [_bswap(f[c] ^ rk[:, 56 + c : 57 + c]) for c in range(4)], dim=-1)
    return u32_to_i32(out)


def aes_ctr_keystream_plain(keys: torch.Tensor, nlo: torch.Tensor,
                            nhi: torch.Tensor, nblocks: int) -> torch.Tensor:
    """keys [N, 32] uint8, nlo/nhi [N] int32 (u32 halves of the 64-bit
    nonce) -> words [N, nblocks, 4] int32 (u32 bit patterns)."""
    return aes_ctr_keystream_rk_plain(round_keys(keys), nlo, nhi, nblocks)
