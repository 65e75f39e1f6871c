"""OS CSPRNG (reference: include/pvac/core/random.hpp:40-110).

Uses os.urandom (getrandom under the hood on Linux).  Little-endian u64
helpers mirror load_le64/store_le64 (random.hpp:26-38).

Small draws are served from a refilling block buffer, so a scalar draw
costs no syscall.  The buffer is shared by every thread of the process,
so the take-and-advance step holds a lock: without it two threads could
read the same bytes.  Bulk helpers keep their single-getrandom path.
"""
from __future__ import annotations

import os
import struct
import threading

import numpy as np

_BLOCK = 1 << 16


class _Pool:
    """Refilling entropy buffer; forked children discard the parent's block
    so two processes never serve the same bytes."""

    def __init__(self):
        self.lock = threading.Lock()
        self.buf = b""
        self.off = 0
        self.pid = -1

    def take(self, n: int) -> bytes:
        with self.lock:
            pid = os.getpid()
            if self.off + n > len(self.buf) or pid != self.pid:
                self.buf = os.urandom(max(_BLOCK, n))
                self.off = 0
                self.pid = pid
            out = self.buf[self.off : self.off + n]
            self.off += n
            return out


_POOL = _Pool()


def csprng_bytes(n: int) -> bytes:
    if n >= 4096:
        return os.urandom(n)
    return _POOL.take(n)


def csprng_u64() -> int:
    return struct.unpack("<Q", _POOL.take(8))[0]


def csprng_u64_array(n: int) -> np.ndarray:
    """n CSPRNG u64s in one getrandom call (numpy uint64 array)."""
    return np.frombuffer(os.urandom(8 * n), dtype="<u8").copy()
