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


# A gather of at least PINNED_MIN_BYTES of rows to the host goes through
# one host buffer of at most this many bytes, a chunk at a time, pinned
# when the rows are on a CUDA device.  CUDA copies to pageable memory at
# the host's pace (fresh pages faulted in as it writes), so the card's
# copy time would follow the host's load: 2.198 and 2.382 s for one
# cell's same 5.8 GB of σ rows on an H100.
PINNED_CHUNK_BYTES = 1 << 26


def rows_to_np_u32(base: torch.Tensor, rows) -> np.ndarray:
    """``base[rows]`` of a 32-bit [N, W] tensor as a host uint32 array,
    gathered on ``base``'s device: under PINNED_MIN_BYTES in one copy,
    else a chunk at a time through a buffer of PINNED_CHUNK_BYTES (pinned
    on a CUDA device) into the result on the host."""
    rows = np.asarray(rows, dtype=np.int64)
    n, w = rows.shape[0], base.shape[1]
    idx = torch.from_numpy(rows).to(base.device)
    if n * w * 4 < PINNED_MIN_BYTES:
        return base.index_select(0, idx).cpu().numpy().view(np.uint32)
    out = np.empty((n, w), dtype=np.uint32)
    cuda = base.device.type == "cuda"
    step = max(1, PINNED_CHUNK_BYTES // (w * 4))
    buf = torch.empty((min(step, n), w), dtype=base.dtype, pin_memory=cuda)
    for s in range(0, n, step):
        k = min(step, n - s)
        buf[:k].copy_(base.index_select(0, idx[s:s + k]), non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(base.device).synchronize()
        out[s:s + k] = buf[:k].numpy().view(np.uint32)
    return out


def from_np_u32(a, device=None) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor (same bits) on ``device``; to a
    CUDA device through pinned memory, without blocking the host, from
    PINNED_MIN_BYTES up."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))
    if (t.nbytes >= PINNED_MIN_BYTES and device is not None
            and torch.device(device).type == "cuda"):
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)

