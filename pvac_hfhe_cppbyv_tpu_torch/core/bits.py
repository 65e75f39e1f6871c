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


def from_np_u32(a, device=None) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor (same bits) on ``device``."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)

