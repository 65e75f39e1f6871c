"""Text codec (reference: include/pvac/utils/text.hpp).

15-byte blocks pack into one field element each; enc_text = [enc(len)] +
one enc_fp_depth per block with increasing depth hints (text.hpp:39-61),
all blocks in one PRF and σ batch.
"""
from __future__ import annotations

import sys

from ..core import field as F
from ..ops.decrypt import dec_value_batch
from ..ops.encrypt import enc_fp_depth_batch, enc_value
from ..types import Cipher, PubKey, SecKey


def pack_15_bytes_to_fp(data: bytes) -> int:
    """At most 15 bytes, little-endian (text.hpp:15-26)."""
    x = int.from_bytes(data[:15], "little")
    return F.fp_from_words(x & ((1 << 64) - 1), x >> 64)


def unpack_fp_to_15_bytes(x: int) -> bytes:
    return bytes((x >> (8 * i)) & 0xFF for i in range(15))


def enc_text(pk: PubKey, sk: SecKey, msg: str | bytes) -> list[Cipher]:
    """enc(len) + one single-layer ciphertext per 15 bytes (text.hpp:39-61)."""
    if isinstance(msg, str):
        msg = msg.encode()
    out = [enc_value(pk, sk, len(msg))]
    blocks = [msg[i : i + 15] for i in range(0, len(msg), 15)]
    if blocks:
        out.extend(enc_fp_depth_batch(pk, sk, [pack_15_bytes_to_fp(b) for b in blocks],
                                      list(range(2, 2 + len(blocks)))))
    return out


def dec_text(pk: PubKey, sk: SecKey, cts: list[Cipher]) -> str:
    """Decrypt, unpack and clip to the decrypted length (text.hpp:63-87)."""
    if not cts:
        return ""
    vals = dec_value_batch(pk, sk, cts)
    if vals[0] >> 64:
        print("text length hi != 0, clipping", file=sys.stderr)
    length = vals[0] & ((1 << 64) - 1)
    buf = b"".join(unpack_fp_to_15_bytes(v) for v in vals[1:])
    return buf[: min(length, len(buf))].decode(errors="replace")
