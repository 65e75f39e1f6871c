"""u32 words in torch tensors.

This torch has no add, shift or compare on uint32 tensors, so the port
holds u32 values two ways: as int64 for arithmetic (value in [0, 2^32)),
and as int32 with the same bit pattern for storage and for the CUDA
kernels, which read the int32 buffers as uint32.  These helpers convert
between the two and from numpy uint32.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor with the same bits."""
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 u32 values."""
    return x.to(torch.int64) & M32


# A copy of at least this many bytes to a CUDA device goes through pinned
# host memory.  From pageable memory CUDA stages a large copy at the
# host's pace, so its time on the card follows the host's load (a depth-3
# product's 3.7 MB σ word chunks: 14-21 GB/s on an H100 host, against 29
# pinned); the σ word passes of depth-1 products (at most 917,504 bytes)
# read faster on the card pageable than pinned.
PINNED_MIN_BYTES = 1 << 20


def from_np_u32(a, device=None) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor (same bits) on ``device``; to a
    CUDA device through pinned memory, without blocking the host, from
    PINNED_MIN_BYTES up."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))
    if (t.nbytes >= PINNED_MIN_BYTES and device is not None
            and torch.device(device).type == "cuda"):
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)

