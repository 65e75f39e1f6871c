"""SHA-256-CTR deterministic streams and k-unique index selection.

Reference: the local ``Ctr`` rngs inside prg_choose_k / gen_ubk_public
(include/pvac/crypto/matrix.hpp:15-164).  A stream is defined by a label and
a list of u64 words; refill c yields the 32-byte digest
SHA-256(label || le64(words...) || le64(c)), read as 4 little-endian u64s.
``bounded(M)`` rejection-samples x <= 2^64-1 - ((2^64-1) % M) and returns
x % M; ``choose_k`` draws until k unique indices are collected.

Two implementations with identical outputs:

- scalar (hashlib) -- exact mirror of the reference control flow; used for
  fallbacks and small host-side jobs;
- vectorized (torch) -- many independent streams at once through the
  plain SHA-256-CTR states (crypto/sha256_ctr.py), generating a static
  overshoot of draws and selecting the first k unique ones with an
  order-preserving, sort-based dedup.  Bounded rejection (probability
  M/2^64 per draw) sets a per-lane fallback flag instead of looping;
  callers re-run flagged lanes through the scalar path.  It serves the
  host (choose_k_batch) and is the twin of kernel B
  (crypto/sigma_draws.py), which does the same on the card without a
  sort; the host route's stream_u64s raises for a tensor off the CPU.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from ..core import hash as H
from .sha256_ctr import lanes_from_u64, shactr_states, shactr_states_plain

U64MAX = (1 << 64) - 1
# Draws past k in a σ stream's window (draws_and_take, kernel B).
OVERSHOOT = 16


# ---------------------------------------------------------------------------
# scalar path (reference mirror)
# ---------------------------------------------------------------------------

class CtrStream:
    """Sequential u64 stream (matrix.hpp:21-76)."""

    def __init__(self, label: str | bytes, words):
        self.prefix = label.encode() if isinstance(label, str) else label
        self.words = [w & U64MAX for w in words]
        self.ctr = 0
        self.buf = b""
        self.idx = 32

    def _refill(self) -> None:
        h = hashlib.sha256()
        h.update(self.prefix)
        for w in self.words:
            h.update(struct.pack("<Q", w))
        h.update(struct.pack("<Q", self.ctr))
        self.ctr += 1
        self.buf = h.digest()
        self.idx = 0

    def rnd(self) -> int:
        if self.idx >= 32:
            self._refill()
        x = struct.unpack_from("<Q", self.buf, self.idx)[0]
        self.idx += 8
        return x

    def bounded(self, M: int) -> int:
        if M <= 1:
            return 0
        lim = U64MAX - (U64MAX % M)
        while True:
            x = self.rnd()
            if x <= lim:
                return x % M


def choose_k_scalar(k: int, N: int, label: str | bytes, words) -> list[int]:
    """prg_choose_k (matrix.hpp:15-92): first k unique bounded draws."""
    rng = CtrStream(label, words)
    used = set()
    out = []
    while len(out) < k:
        x = rng.bounded(N)
        if x not in used:
            used.add(x)
            out.append(x)
    return out


# ---------------------------------------------------------------------------
# vectorized path (torch)
# ---------------------------------------------------------------------------

def _stream(states, label: str | bytes, lanes: torch.Tensor, n_u64: int) -> torch.Tensor:
    prefix = label.encode() if isinstance(label, str) else label
    n_refills = (n_u64 + 3) // 4
    state = states(prefix, lanes, n_refills).to(torch.int64) & 0xFFFFFFFF
    u64s = H.digest_words_to_le_u64_pairs(state)  # [L, R, 4, 2]
    return u64s.reshape(lanes.shape[0], n_refills * 4, 2)[:, :n_u64]


def stream_u64s_plain(label: str | bytes, lanes: torch.Tensor, n_u64: int) -> torch.Tensor:
    """lanes [L, n_words, 2] int32 (lo, hi) per lane -> [L, n_u64, 2] int64
    u32 halves of the stream's little-endian u64s, in stream order, by
    torch ops on the lanes' device: the first stage of kernel B's twin."""
    return _stream(shactr_states_plain, label, lanes, n_u64)


def stream_u64s(label: str | bytes, lanes: torch.Tensor, n_u64: int) -> torch.Tensor:
    """:func:`stream_u64s_plain` as a host route: raises for a tensor that
    is not on the CPU, where the σ draws run in kernel B."""
    return _stream(shactr_states, label, lanes, n_u64)


def mod_u64(u64_pairs: torch.Tensor, M: int) -> torch.Tensor:
    """x mod M for u64s given as (lo32, hi32) pairs (M < 2^16)."""
    if not 1 <= M < (1 << 16):
        raise ValueError(f"modulus out of range: {M}")
    t32 = (1 << 32) % M
    return ((u64_pairs[..., 1] % M) * t32 + u64_pairs[..., 0] % M) % M


def bounded_ok_mask(u64_pairs: torch.Tensor, M: int) -> torch.Tensor:
    """True where x <= lim = 2^64-1 - ((2^64-1) % M) (acceptance mask)."""
    lim = U64MAX - (U64MAX % M)
    lim_lo, lim_hi = lim & 0xFFFFFFFF, lim >> 32
    lo, hi = u64_pairs[..., 0], u64_pairs[..., 1]
    return (hi < lim_hi) | ((hi == lim_hi) & (lo <= lim_lo))


def first_occurrence(vals: torch.Tensor) -> torch.Tensor:
    """[L, D] values -> [L, D] bool, True at the first occurrence of each
    value in its row.  Sort-based: O(L*D) memory (a pairwise compare would
    hold an [L, D, D] mask)."""
    L, D = vals.shape
    pos = torch.arange(D, dtype=torch.int64, device=vals.device)
    packed = vals.to(torch.int64) * D + pos
    srt, order = torch.sort(packed, dim=-1)
    sv = srt // D
    first_sorted = torch.ones_like(sv, dtype=torch.bool)
    first_sorted[:, 1:] = sv[:, 1:] != sv[:, :-1]
    return torch.zeros_like(first_sorted).scatter_(1, order, first_sorted)


def draws_and_take(k: int, N: int, label: str | bytes, lanes: torch.Tensor,
                   overshoot: int = OVERSHOOT):
    """Vectorized prg_choose_k without the order-compaction step.

    Returns (vals [L, D] int64, take [L, D] bool, fallback [L] bool) where
    ``take`` marks the first k first-occurrence draws (D = k + overshoot).
    Every consumer of the selected indices is order-insensitive (XOR of H
    rows, XOR of single bits), so the set {vals[take]} is all that's needed.
    Lanes where the D-draw window can't produce k uniques, or a bounded
    rejection occurs, are flagged for the scalar fallback."""
    D = k + overshoot
    u64s = stream_u64s_plain(label, lanes, D)
    ok = bounded_ok_mask(u64s, N)
    vals = mod_u64(u64s, N)
    first = first_occurrence(vals)
    rank = torch.cumsum(first.to(torch.int32), dim=-1)
    take = first & (rank <= k)
    fallback = (rank[:, -1] < k) | (~ok).any(dim=-1)
    return vals, take, fallback


def choose_k_batch(k: int, N: int, label: str | bytes, words: np.ndarray,
                   overshoot: int = 64):
    """Vectorized prg_choose_k over many lanes, on the host.

    words: [L, n_words] uint64.  Returns (indices [L, k] int32 in stream
    order, fallback [L] bool) as numpy arrays; ``fallback`` lanes must be
    recomputed with :func:`choose_k_scalar`."""
    vals, take, fallback = draws_and_take(
        k, N, label, lanes_from_u64(words), overshoot=overshoot)
    rank = torch.cumsum(take.to(torch.int64), dim=-1)
    dst = torch.where(take, rank - 1, torch.full_like(rank, k))
    out = torch.zeros((vals.shape[0], k + 1), dtype=torch.int64)
    out.scatter_(1, dst, torch.where(take, vals, torch.zeros_like(vals)))
    return out[:, :k].numpy().astype(np.int32), fallback.numpy()
