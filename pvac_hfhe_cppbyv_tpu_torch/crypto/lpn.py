"""LPN-based PRF R (reference: include/pvac/crypto/lpn.hpp:157-275).

prf_R(pk, sk, seed) = prod of three domain-separated cores; each core:
  1. derive_aes_key = SHA-256(prf_k || canon_tag || H_digest || seed || dom)
     (lpn.hpp:166-192), nonce = fnv1a(dom) ^ seed.nonce.lo
  2. t LPN samples y_r = <a_r, s> xor Ber(tau), a_r = 64 AES-CTR u64s per
     row, noise draw = bounded(8) < 1 (lpn.hpp:194-233)
  3. GF(2) Toeplitz compression to 127 bits with an AES-CTR top row from a
     TOEP-domain key (lpn.hpp:235-261)
  4. map to a nonzero field element (lpn.hpp:25-37)

Only LPN rows 0..126 (and the first Toeplitz block) influence the output,
because convolution bit k depends only on operand bits 0..k; the batched
path computes exactly those rows.

With an engine holding the secret key attached, the raw seeds go to the
engine's device and both AES keys of every core derive there
(:func:`derive_keys_device`: SHA-256 through kernel D); with none, keys
derive on the host (native SHA-NI, or hashlib).  Kernel A
(crypto/lpn_ybits.py) takes the keys to the 127 LPN bits of each core
(keystream, parity and noise in one pass), and kernel E
(crypto/toep_core.py) takes the Toeplitz key and those bits to the field
element (the one-block Toeplitz stream, the hash and the field map in one
pass), on whatever device the key tensors live on: the engine's card, or
the CPU through the twins.

Bounded rejection in the noise draw (probability 8/2^64 per row) would
shift the stream; the batch path flags it and recomputes affected lanes
with the exact scalar mirror.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from .. import native
from ..core import field as F
from ..core import fieldv as FV
from ..core import hash as H
from ..core.bits import M32, from_np_u32, i32_to_u32, u32_to_i32
from ..types import Dom, Nonce128, PubKey, RSeed, SecKey
from . import aes as AES
from . import toeplitz as TOEP
from .lpn_ybits import lpn_ybits
from .sha256_blocks import sha256_blocks
from .toep_core import toep_core

U64MAX = (1 << 64) - 1

# Cores per device pass when no engine is attached (CPU tensors): the
# plain AES twin holds ~20 int64 [chunk, 4128] temporaries.
PRF_CHUNK_CPU = 512


def fnv1a_domain(dom: str | bytes) -> int:
    """FNV-1a of a domain string (lpn.hpp:157-164)."""
    if isinstance(dom, str):
        dom = dom.encode()
    h = 0xCBF29CE484222325
    for b in dom:
        h ^= b
        h = (h * 0x100000001B3) & U64MAX
    return h


DOM_HASH = {
    d: fnv1a_domain(d)
    for d in (
        Dom.H_GEN, Dom.X_SEED, Dom.NOISE, Dom.PRF_LPN, Dom.TOEP, Dom.ZTAG,
        Dom.COMMIT, Dom.PRF_R1, Dom.PRF_R2, Dom.PRF_R3,
        Dom.PRF_NOISE1, Dom.PRF_NOISE2, Dom.PRF_NOISE3,
    )
}


def hash_to_fp_nonzero(lo: int, hi: int) -> int:
    """(lo, hi) -> nonzero field element (lpn.hpp:25-37)."""
    r = F.fp_from_words(lo, hi & F.MASK63)
    return r if r else 1


def _key_prefix(pk: PubKey, sk: SecKey) -> bytes:
    parts = [struct.pack("<Q", k & U64MAX) for k in sk.prf_k]
    parts.append(struct.pack("<Q", pk.canon_tag & U64MAX))
    parts.append(pk.H_digest)
    return b"".join(parts)


def derive_aes_key(pk: PubKey, sk: SecKey, seed: RSeed, dom: str) -> tuple[bytes, int]:
    """Scalar derive_aes_key (lpn.hpp:166-192)."""
    dom_hash = DOM_HASH.get(dom) or fnv1a_domain(dom)
    msg = _key_prefix(pk, sk) + struct.pack(
        "<QQQQ", seed.ztag & U64MAX, seed.nonce.lo & U64MAX,
        seed.nonce.hi & U64MAX, dom_hash,
    )
    return hashlib.sha256(msg).digest(), dom_hash ^ (seed.nonce.lo & U64MAX)


def lpn_make_ybits(pk: PubKey, sk: SecKey, seed: RSeed, dom: str,
                   n_rows: int | None = None) -> list[int]:
    """Scalar mirror of lpn_make_ybits (lpn.hpp:194-233); optionally only the
    first n_rows rows.  Handles bounded rejections exactly."""
    t = pk.prm.lpn_t if n_rows is None else min(n_rows, pk.prm.lpn_t)
    s_words = pk.prm.s_words64
    key, nonce = derive_aes_key(pk, sk, seed, dom)
    prg = AES.AesCtr256(key, nonce)
    ybits = [0] * ((pk.prm.lpn_t + 63) // 64)
    num, den = pk.prm.lpn_tau_num, pk.prm.lpn_tau_den
    for r in range(t):
        row = prg.fill_u64(s_words)
        acc = 0
        for wi in range(s_words):
            acc ^= row[wi] & sk.lpn_s_bits[wi]
        dot = bin(acc).count("1") & 1
        e = 1 if prg.bounded(den) < num else 0
        ybits[r >> 6] ^= (dot ^ e) << (r & 63)
    return ybits


def _toep_key_nonce(pk: PubKey, sk: SecKey, seed: RSeed, dom: str) -> tuple[bytes, int]:
    key, nonce = derive_aes_key(pk, sk, seed, Dom.TOEP)
    return key, nonce ^ (DOM_HASH.get(dom) or fnv1a_domain(dom))


# ---------------------------------------------------------------------------
# batched cores
# ---------------------------------------------------------------------------

def _rows_per_core(prm) -> int:
    # only LPN rows 0..126 influence the 127 toep output bits
    return min(127, prm.lpn_t)


def derive_keys_batch(pk: PubKey, sk: SecKey, seeds_u64: np.ndarray,
                      dom_hashes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized derive_aes_key.  seeds_u64 [N, 3] uint64 (ztag, lo, hi),
    dom_hashes [N] uint64 -> (keys [N, 32] uint8, nonces [N] uint64).

    Uses the threaded native SHA (SHA-NI) when available, else hashlib."""
    prefix = _key_prefix(pk, sk)
    f64 = np.concatenate([seeds_u64, dom_hashes[:, None]], axis=1).astype(np.uint64)
    nonces = (dom_hashes ^ seeds_u64[:, 1]).astype(np.uint64)
    keys = native.sha256_fields(prefix, f64)
    if keys is None:
        keys = np.frombuffer(b"".join(
            hashlib.sha256(prefix + row.astype("<u8").tobytes()).digest()
            for row in f64), dtype=np.uint8).reshape(-1, 32)
    return keys, nonces


def derive_layout(pk: PubKey, sk: SecKey) -> H.MsgLayout:
    """The derive_aes_key message layout: prefix prf_k || canon_tag ||
    H_digest, then 4 u64 fields (ztag, nonce_lo, nonce_hi, dom_hash)."""
    return H.MsgLayout(_key_prefix(pk, sk), 4)


def derive_keys_device(layout: H.MsgLayout, tmpl: torch.Tensor,
                       fields4: torch.Tensor) -> torch.Tensor:
    """derive_aes_key on a device: fields4 [n, 4, 2] int64 (lo, hi u32 of
    ztag, nonce_lo, nonce_hi, dom_hash) and tmpl (the layout's
    template_tensor) on one device -> digest bytes [n, 32] uint8 there.
    The digests run through kernel D on CUDA, its twin on the CPU; the
    key bytes are BE(h0) || .. || BE(h7).  Equal to derive_keys_batch."""
    blocks = u32_to_i32(layout.build_blocks(fields4, tmpl)).contiguous()
    h = i32_to_u32(sha256_blocks(blocks))  # [n, 8]
    sh = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=h.device)
    return ((h[:, :, None] >> sh) & 0xFF).to(torch.uint8).reshape(-1, 32)


def prf_cores_device(prm, keys, nlo, nhi, tkeys, tnlo, tnhi, s32):
    """The prf_R core program on one device: tensors keys/tkeys [N, 32]
    uint8, nonce halves [N] int32, s32 [2 * s_words64] int32.  Returns
    (r [N, 4] int64 limbs, rej [N] bool) on that device.  Kernel A takes
    the keys to the LPN bits, kernel E the Toeplitz keys and those bits to
    the cores: two launches on the card."""
    y, rej = lpn_ybits(keys, nlo, nhi, s32, _rows_per_core(prm),
                       prm.lpn_tau_num, prm.lpn_tau_den)
    return toep_core(tkeys, tnlo, tnhi, y), rej


_TOEP_HALVES = (DOM_HASH[Dom.TOEP] & M32, DOM_HASH[Dom.TOEP] >> 32)


def prf_cores_device_seeds(prm, layout: H.MsgLayout, tmpl: torch.Tensor,
                           f3: torch.Tensor, dh: torch.Tensor, s32: torch.Tensor):
    """The prf_R core program with its keys derived on the device: f3
    [n, 3, 2] int64 (ztag, nonce_lo, nonce_hi as u32 halves), dh [n, 2]
    int64 dom-hash halves, tmpl and s32 all on one device -> (r [n, 4]
    int64, rej [n] bool) there.  Main and Toeplitz keys derive in one pass
    of kernel D; nonce = dom_hash ^ nonce_lo and Toeplitz nonce =
    TOEP ^ nonce_lo ^ dom_hash, per u32 half."""
    n = f3.shape[0]
    tc = torch.tensor(_TOEP_HALVES, dtype=torch.int64, device=f3.device)
    f_main = torch.cat([f3, dh[:, None, :]], dim=1)
    f_toep = torch.cat([f3, tc.expand(n, 1, 2)], dim=1)
    keys = derive_keys_device(layout, tmpl, torch.cat([f_main, f_toep]))
    lo = f3[:, 1]
    nonce = u32_to_i32(dh ^ lo)
    tnonce = u32_to_i32(tc ^ lo ^ dh)
    return prf_cores_device(prm, keys[:n], nonce[:, 0].contiguous(),
                            nonce[:, 1].contiguous(), keys[n:],
                            tnonce[:, 0].contiguous(), tnonce[:, 1].contiguous(),
                            s32)


def _nonce_halves(nonces: np.ndarray, device):
    n = np.ascontiguousarray(nonces, dtype=np.uint64).view(np.uint32).reshape(-1, 2)
    return (from_np_u32(np.ascontiguousarray(n[:, 0]), device),
            from_np_u32(np.ascontiguousarray(n[:, 1]), device))


def prf_cores_tensors(prm, keys, nonces, toep_keys, toep_nonces, s32_dev,
                      chunk: int):
    """Host keys and nonces -> (r [N, 4] int64, rej [N] bool) on s32_dev's
    device, in passes of at most ``chunk`` cores.  No synchronisation: the
    results stay on the device until the caller reads them."""
    dev = s32_dev.device
    rs, rejs = [], []
    for off in range(0, keys.shape[0], chunk):
        sl = slice(off, off + chunk)
        nlo, nhi = _nonce_halves(nonces[sl], dev)
        tnlo, tnhi = _nonce_halves(toep_nonces[sl], dev)
        r, rej = prf_cores_device(
            prm, torch.from_numpy(np.ascontiguousarray(keys[sl])).to(dev), nlo, nhi,
            torch.from_numpy(np.ascontiguousarray(toep_keys[sl])).to(dev), tnlo, tnhi,
            s32_dev)
        rs.append(r)
        rejs.append(rej)
    if not rs:
        return (torch.zeros((0, 4), dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    return torch.cat(rs), torch.cat(rejs)


def s32_tensor(sk: SecKey, device=None) -> torch.Tensor:
    """The LPN secret as an int32 tensor [2 * s_words64] on ``device``."""
    return from_np_u32(sk.s_words32().reshape(-1), device)


def prf_cores_batch_start(pk: PubKey, sk: SecKey, seeds_u64: np.ndarray,
                          dom_hashes: np.ndarray):
    """N independent prf_R_core evaluations, split into dispatch + finalize
    so callers overlap host work with the device computation.

    seeds_u64: [N, 3] uint64 (ztag, nonce_lo, nonce_hi); dom_hashes [N].
    With an engine attached, the seeds go to its device and the keys
    derive there (an engine attached without sk binds this one); with
    none, keys derive on the host, as the JAX path without an engine does.
    Returns a zero-arg finalize() -> [N, 4] uint32 field limbs (numpy)."""
    engine = getattr(pk, "_engine", None)
    if engine is not None:
        engine.bind_sk(sk)
        r_dev, rej_dev = engine.prf_cores_async_seeds(seeds_u64, dom_hashes)
    else:
        N = seeds_u64.shape[0]
        keys, nonces = derive_keys_batch(pk, sk, seeds_u64, dom_hashes)
        toep_keys, toep_base = derive_keys_batch(
            pk, sk, seeds_u64, np.full(N, DOM_HASH[Dom.TOEP], dtype=np.uint64))
        r_dev, rej_dev = prf_cores_tensors(pk.prm, keys, nonces, toep_keys,
                                           toep_base ^ dom_hashes, s32_tensor(sk),
                                           PRF_CHUNK_CPU)

    def finalize():
        r = FV.to_u32(r_dev)
        rej = rej_dev.cpu().numpy()
        # exact fallback for bounded-rejection lanes
        for n in np.nonzero(rej)[0]:
            seed = RSeed(int(seeds_u64[n, 0]),
                         Nonce128(int(seeds_u64[n, 1]), int(seeds_u64[n, 2])))
            r[n] = _prf_core_exact_scalar(pk, sk, seed, int(dom_hashes[n]))
        return r

    return finalize


def prf_cores_batch(pk: PubKey, sk: SecKey, seeds_u64: np.ndarray,
                    dom_hashes: np.ndarray) -> np.ndarray:
    """Synchronous prf_cores_batch_start: dispatch + finalize in one call."""
    return prf_cores_batch_start(pk, sk, seeds_u64, dom_hashes)()


def _prf_core_exact_scalar(pk: PubKey, sk: SecKey, seed, dom_hash: int) -> np.ndarray:
    """Slow exact mirror used only when a bounded() rejection occurred."""
    dom = next(d for d, h in DOM_HASH.items() if h == dom_hash)
    yb = lpn_make_ybits(pk, sk, seed, dom)
    key, nonce = _toep_key_nonce(pk, sk, seed, dom)
    prg = AES.AesCtr256(key, nonce)
    top_words = prg.fill_u64((pk.prm.lpn_t + 127 + 63) // 64)
    lo, hi = TOEP.toep_127_scalar(top_words, yb)
    v = hash_to_fp_nonzero(lo, hi)
    return np.array([(v >> (32 * k)) & M32 for k in range(4)], dtype=np.uint32)


def prf_R_core(pk: PubKey, sk: SecKey, seed: RSeed, dom: str) -> int:
    """One core as a single-lane prf_cores_batch: with an engine attached,
    kernels D, A and E on its device."""
    r = prf_cores_batch(
        pk, sk,
        np.array([[seed.ztag, seed.nonce.lo, seed.nonce.hi]], dtype=np.uint64),
        np.array([DOM_HASH.get(dom) or fnv1a_domain(dom)], dtype=np.uint64),
    )
    return FV.to_ints(FV.from_u32(r))[0]


def _prf_R_doms(pk: PubKey, sk: SecKey, seed: RSeed, doms) -> int:
    r1, r2, r3 = (prf_R_core(pk, sk, seed, d) for d in doms)
    return F.fp_mul(F.fp_mul(r1, r2), r3)


def prf_R(pk: PubKey, sk: SecKey, seed: RSeed) -> int:
    """prf_R: the product of the three R-domain cores."""
    return _prf_R_doms(pk, sk, seed, (Dom.PRF_R1, Dom.PRF_R2, Dom.PRF_R3))


def prf_R_noise(pk: PubKey, sk: SecKey, seed: RSeed) -> int:
    """prf_R_noise: the product of the three noise-domain cores."""
    return _prf_R_doms(pk, sk, seed, (Dom.PRF_NOISE1, Dom.PRF_NOISE2, Dom.PRF_NOISE3))


def prf_R_batch(pk: PubKey, sk: SecKey, seeds_u64: np.ndarray,
                noise: bool = False) -> torch.Tensor:
    """Batched prf_R / prf_R_noise over N seeds -> [N, 4] int64 limbs (CPU)."""
    N = seeds_u64.shape[0]
    doms = (Dom.PRF_NOISE1, Dom.PRF_NOISE2, Dom.PRF_NOISE3) if noise else (
        Dom.PRF_R1, Dom.PRF_R2, Dom.PRF_R3)
    seeds3 = np.repeat(seeds_u64, 3, axis=0)
    dh = np.tile(np.array([DOM_HASH[d] for d in doms], dtype=np.uint64), N)
    cores = FV.from_u32(prf_cores_batch(pk, sk, seeds3, dh)).reshape(N, 3, 4)
    return FV.mul(FV.mul(cores[:, 0], cores[:, 1]), cores[:, 2])
