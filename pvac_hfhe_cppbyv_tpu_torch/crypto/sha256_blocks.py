"""SHA-256 of many pre-padded fixed-length messages: kernel D and its
plain twin.

Message i is ``blocks[i]`` [nb, 16], u32 big-endian message words with the
0x80 pad byte and the bit length already in place (core/hash.MsgLayout
builds them); its digest is the final state h0..h7, so the digest bytes
are BE(h0) .. BE(h7).  This is the value of the JAX package's
sha256_pallas.sha256_many.

:func:`sha256_blocks` launches the CUDA kernel (kernels/sha256_blocks.cu)
for CUDA tensors and runs :func:`sha256_blocks_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from .. import kernels
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


def sha256_blocks_cuda(blocks: torch.Tensor) -> torch.Tensor:
    """Kernel D on a CUDA tensor; same contract as the plain twin."""
    dev = kernels.check_cuda(blocks, dtypes=(torch.int32,))
    if blocks.dim() != 3 or blocks.shape[2] != 16 or blocks.shape[1] < 1:
        raise ValueError("expected blocks [I, nb >= 1, 16]")
    I, nb = blocks.shape[0], blocks.shape[1]
    out = torch.empty((I, 8), dtype=torch.int32, device=dev)
    if I == 0:
        return out
    kernels.launch("sha256_blocks", kernels.lib().pvk_sha256_blocks, dev,
                   blocks.data_ptr(), I, nb, out.data_ptr())
    return out


def sha256_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Kernel D for CUDA tensors, its plain twin for CPU tensors."""
    if blocks.device.type == "cuda":
        return sha256_blocks_cuda(blocks)
    if blocks.device.type == "cpu":
        return sha256_blocks_plain(blocks)
    raise ValueError(f"unsupported device {blocks.device}")
