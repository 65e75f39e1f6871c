"""Ciphertext commitment (reference: include/pvac/ops/commit.hpp:12-87)."""
from __future__ import annotations

import hashlib
import struct

import numpy as np

from ..core.field import MASK63
from ..types import Cipher, Dom, PubKey, RRULE_BASE, sigma_to_host

U64MAX = (1 << 64) - 1


def commit_ct(pk: PubKey, C: Cipher) -> bytes:
    """SHA-256 over domain || H_digest || canon_tag || layers || edges.

    Each edge hashes as le64 layer id, le64 idx, u8 sign, the weight as
    le64 lo and le64 hi (bit 127 cleared) and the first ceil(m_bits / 8)
    bytes of its σ row; the edge records are built as one byte array."""
    h = hashlib.sha256()
    h.update(Dom.COMMIT.encode())
    h.update(pk.H_digest)
    h.update(struct.pack("<Q", pk.canon_tag & U64MAX))
    for L in C.layers:
        h.update(bytes([L.rule]))
        if L.rule == RRULE_BASE:
            h.update(struct.pack("<QQQ", L.seed.ztag & U64MAX,
                                 L.seed.nonce.lo & U64MAX,
                                 L.seed.nonce.hi & U64MAX))
        else:
            h.update(struct.pack("<QQ", L.pa, L.pb))
    if C.n_edges:
        nbytes = (pk.prm.m_bits + 7) // 8
        sig = sigma_to_host(C.sigma).astype("<u4").view(np.uint8)[:, :nbytes]
        w = np.asarray(C.w, dtype=np.uint64)
        rec = np.zeros(C.n_edges, dtype=[("lid", "<u8"), ("idx", "<u8"), ("ch", "u1"),
                                          ("lo", "<u8"), ("hi", "<u8"),
                                          ("sig", "u1", (nbytes,))])
        rec["lid"] = C.layer_id.astype(np.int64).astype(np.uint64)
        rec["idx"] = C.idx.astype(np.int64).astype(np.uint64)
        rec["ch"] = C.ch.astype(np.uint8)
        rec["lo"] = w[:, 0] | (w[:, 1] << np.uint64(32))
        rec["hi"] = (w[:, 2] | (w[:, 3] << np.uint64(32))) & np.uint64(MASK63)
        rec["sig"] = sig
        h.update(rec.tobytes())
    return h.digest()
