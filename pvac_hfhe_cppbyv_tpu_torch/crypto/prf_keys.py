"""PRF key derivation from raw seeds: kernel D and its plain twin.

A prf_R core with seed (ztag, nonce_lo, nonce_hi) in domain d keys two
AES-256 streams (crypto/lpn.derive_aes_key, lpn.hpp:166-192):

- key = SHA-256(prefix || le64(ztag) || le64(nonce_lo) || le64(nonce_hi)
  || le64(dom_hash)), nonce = dom_hash ^ nonce_lo, for kernel A;
- tkey, the same message with TOEP's hash for dom_hash, and tnonce =
  TOEP ^ nonce_lo ^ dom_hash, for kernel E;

where prefix = prf_k || canon_tag || H_digest is fixed per key pair.
:func:`key_msg` compresses the prefix's whole blocks once per key pair
(the midstate) and keeps the template of the remaining blocks (the tail),
so each key costs the tail's compressions alone: one block at the
scheme's 72-byte prefix.

:func:`prf_keys` takes seeds [n, 4] int64 (ztag, nonce_lo, nonce_hi,
dom_hash as u64 bit patterns) to keys [2, n, 32] uint8 (row 0 the main
keys, row 1 the Toeplitz keys; digest bytes BE(h0) .. BE(h7)) and nonces
[4, n] int32 (nonce's low and high u32 halves, then tnonce's).  It
launches kernel D (kernels/prf_keys.cu) for CUDA tensors and runs
:func:`prf_keys_plain` for CPU tensors.  The value is that of the JAX
package's derive_keys_xp (the Pallas sha256_many of the same messages)
plus the nonce XORs of its prf_program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..core import hash as H
from ..core.bits import M32, u32_to_i32

# tail blocks kernel D takes after the midstate (kMaxTail in prf_keys.cu)
MAX_TAIL_BLOCKS = 2


class KeyMsg(NamedTuple):
    """A key pair's derivation message after its prefix-only blocks."""

    mid: np.ndarray   # [8] uint32: the SHA-256 state after them
    tail: np.ndarray  # [nt * 16] uint32: big-endian template words of the rest
    fpos: int         # byte of the tail where the four u64 fields start


def key_msg(prefix: bytes) -> KeyMsg:
    """The midstate and tail of the message prefix || 4 u64 fields: the
    prefix's len(prefix) // 64 whole blocks compressed on the CPU (hashlib
    exposes no midstate), the other blocks kept as a template."""
    layout = H.MsgLayout(prefix, 4)
    words = torch.from_numpy(layout.template_words().astype(np.int64))
    hoist = len(prefix) // 64
    state = H.sha256_init_state(())
    for b in range(hoist):
        state = H.sha256_compress(state, words[16 * b:16 * (b + 1)])
    return KeyMsg(state.numpy().astype(np.uint32), words[16 * hoist:].numpy().astype(np.uint32),
                  len(prefix) - 64 * hoist)


def _check(msg: KeyMsg) -> int:
    """Raise on a message kernel D cannot take; returns its tail blocks."""
    nt = msg.tail.shape[0] // 16
    if msg.mid.shape != (8,) or msg.tail.shape != (16 * nt,) or not 1 <= nt <= MAX_TAIL_BLOCKS:
        raise ValueError(f"expected mid [8] and tail [16 nt], 1 <= nt <= {MAX_TAIL_BLOCKS}")
    if msg.fpos < 0:
        raise ValueError("the fields would straddle a hoisted block")
    if msg.fpos % 4 or msg.fpos + 32 + 9 > 64 * nt:
        raise ValueError(f"the fields at byte {msg.fpos} are not word-aligned in the tail "
                         f"before its pad byte and length")
    return nt


def _i64(v: int) -> int:
    """A u64 value as the int64 of the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def prf_keys_plain(msg: KeyMsg, seeds4: torch.Tensor, toep: int):
    """seeds4 [n, 4] int64 -> (keys [2, n, 32] uint8, nonces [4, n] int32)
    as in the module docstring: the tails built with vector ops on int64
    words, then core/hash.sha256_compress from the midstate."""
    nt = _check(msg)
    dev, n = seeds4.device, seeds4.shape[0]
    tc = torch.tensor(_i64(toep), dtype=torch.int64, device=dev)
    f = torch.stack([seeds4, seeds4.clone()])  # [2, n, 4]: main, Toeplitz
    f[1, :, 3] = tc
    # le64 at a word-aligned byte is the big-endian words bswap(lo), bswap(hi)
    fw = H.bswap32(torch.stack([f & M32, (f >> 32) & M32], dim=-1)).reshape(2, n, 8)
    words = torch.from_numpy(msg.tail.astype(np.int64)).to(dev).repeat(2, n, 1)
    w0 = msg.fpos // 4
    words[..., w0:w0 + 8] = fw
    state = torch.from_numpy(msg.mid.astype(np.int64)).to(dev).expand(2, n, 8)
    for b in range(nt):
        state = H.sha256_compress(state, words[..., 16 * b:16 * (b + 1)])
    # key byte 4k + j is byte 3 - j of h_k: the little-endian bytes of bswap(h_k)
    keys = u32_to_i32(H.bswap32(state)).contiguous().view(torch.uint8).reshape(2, n, 32)
    nonce = seeds4[:, 3] ^ seeds4[:, 1]
    nn = torch.stack([nonce, nonce ^ tc])  # [2, n]
    nonces = u32_to_i32(torch.stack([nn & M32, (nn >> 32) & M32], dim=1).reshape(4, n))
    return keys, nonces


def prf_keys_cuda(msg: KeyMsg, seeds4: torch.Tensor, toep: int):
    """Kernel D on a CUDA tensor; same contract as the plain twin."""
    nt = _check(msg)
    dev = kernels.check_cuda(seeds4, dtypes=(torch.int64,))
    if seeds4.dim() != 2 or seeds4.shape[1] != 4:
        raise ValueError("expected seeds4 [n, 4]")
    if seeds4.data_ptr() % 16:
        raise ValueError("seeds4 must be 16-byte aligned")
    n = seeds4.shape[0]
    keys = torch.empty((2, n, 32), dtype=torch.uint8, device=dev)
    nonces = torch.empty((4, n), dtype=torch.int32, device=dev)
    if n == 0:
        return keys, nonces
    # host memory: the launch copies the midstate and tail into the kernel's parameters
    mid = np.ascontiguousarray(msg.mid, dtype=np.uint32)
    tail = np.ascontiguousarray(msg.tail, dtype=np.uint32)
    kernels.launch("prf_keys", kernels.lib().pvk_prf_keys, dev, seeds4.data_ptr(), n,
                   mid.ctypes.data, tail.ctypes.data, nt, msg.fpos, toep,
                   keys.data_ptr(), nonces.data_ptr())
    return keys, nonces


def prf_keys(msg: KeyMsg, seeds4: torch.Tensor, toep: int):
    """Kernel D for CUDA tensors, its plain twin for CPU tensors."""
    if seeds4.device.type == "cuda":
        return prf_keys_cuda(msg, seeds4, toep)
    if seeds4.device.type == "cpu":
        return prf_keys_plain(msg, seeds4, toep)
    raise ValueError(f"unsupported device {seeds4.device}")
