"""SHA-256 of many pre-padded fixed-length messages in plain torch.

Message i is ``blocks[i]`` [nb, 16], u32 big-endian message words with the
0x80 pad byte and the bit length already in place (core/hash.MsgLayout
builds them); its digest is the final state h0..h7, so the digest bytes
are BE(h0) .. BE(h7).  This is the value of the JAX package's
sha256_pallas.sha256_many, on any device.  The scheme's one use of that
function, PRF key derivation, runs on the card in kernel D
(crypto/prf_keys.py), which builds its messages itself from a midstate.
"""
from __future__ import annotations

import torch

from ..core import hash as H
from ..core.bits import i32_to_u32, u32_to_i32


def sha256_blocks_plain(blocks: torch.Tensor) -> torch.Tensor:
    """blocks [I, nb, 16] int32 (u32 bit patterns) -> digests [I, 8] int32,
    chaining core/hash.sha256_compress."""
    w = i32_to_u32(blocks)
    state = H.sha256_init_state(blocks.shape[:1], blocks.device)
    for b in range(blocks.shape[1]):
        state = H.sha256_compress(state, w[:, b])
    return u32_to_i32(state)
