"""Hypergraph / syndrome machinery (reference: include/pvac/crypto/matrix.hpp).

- prg_choose_k: k unique indices from a SHA-256-CTR stream (:15-92)
- gen_ubk_public: public Fisher-Yates permutation from canon_tag (:95-164)
- apply_perm_sigma / ubk_apply: bit permutation of σ rows (:167-188,
  :306-310)
- gen_H: n_bits sparse columns of m_bits, col weight h_col_wt, plus the
  streaming H digest (:191-251)
- prg_layer_ztag: layer tag hash (:254-264)
- sigma_from_H / sigma rows: XOR of x_col_wt H columns + err_wt noise
  bits (:267-303)

H is a packed uint32 bit matrix [n_bits, m_words32] on the host; σ
generation runs batched over edges on a device: the draw streams and the
selection of the taken draws through kernel B (crypto/sigma_draws.py),
the row XOR and noise bits through kernel C (crypto/sigma_xor.py), or
both in one launch on a card that holds the whole table
(crypto/sigma_fused.py).
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from .. import native
from ..types import Cipher, Dom, Nonce128, PubKey, Ubk, sigma_to_host
from . import shactr, sigma_fused
from .sha256_ctr import lanes_from_u64
from .sigma_draws import taken_indices
from .sigma_xor import sigma_rows

U32 = np.uint32

# Edges per device pass when no engine is attached (CPU tensors).
SIGMA_CHUNK_CPU = 4096


def prg_choose_k(k: int, N: int, label: str, words) -> list[int]:
    """Scalar prg_choose_k (matrix.hpp:15-92)."""
    return shactr.choose_k_scalar(k, N, label, words)


def gen_ubk_public(canon_tag: int, m_bits: int) -> Ubk:
    """Public permutation from canon_tag (matrix.hpp:95-164)."""
    perm = list(range(m_bits))
    rng = shactr.CtrStream("UBK", [canon_tag])
    for i in range(m_bits - 1, 0, -1):
        j = rng.bounded(i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    perm = np.asarray(perm, dtype=np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(m_bits, dtype=np.int32)
    return Ubk(perm=perm, inv=inv)


def apply_perm_sigma(sigma: np.ndarray, inv: np.ndarray) -> np.ndarray:
    """Permute σ bits: out[inv[src]] = in[src], i.e. out[j] = in[perm[j]]
    (matrix.hpp:167-188).  sigma [..., W] uint32 packed, inv int32 [m]."""
    m = inv.shape[0]
    perm = np.empty_like(inv)
    perm[inv] = np.arange(m, dtype=inv.dtype)
    bits = (sigma[..., perm // 32] >> (perm % 32).astype(U32)) & U32(1)
    bits = bits.reshape(*bits.shape[:-1], m // 32, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(axis=-1, dtype=np.uint64).astype(U32)


def ubk_apply(pk: PubKey, C: Cipher) -> None:
    """Permute every edge's σ in place (matrix.hpp:306-310)."""
    if C.n_edges:
        C.sigma = apply_perm_sigma(sigma_to_host(C.sigma), pk.ubk.inv)


def gen_H(pk: PubKey) -> None:
    """Generate H columns + digest into pk (matrix.hpp:191-251)."""
    prm = pk.prm
    m, n, wt = prm.m_bits, prm.n_bits, prm.h_col_wt
    mw = prm.sigma_words32

    # per-column stream words: {m, n, wt, c, canon_tag}
    words = np.zeros((n, 5), dtype=np.uint64)
    words[:, 0] = m
    words[:, 1] = n
    words[:, 2] = wt
    words[:, 3] = np.arange(n, dtype=np.uint64)
    words[:, 4] = pk.canon_tag
    rows_idx = native.choose_k(Dom.H_GEN.encode(), words, wt, m)
    if rows_idx is None:
        rows_idx, fb = shactr.choose_k_batch(wt, m, Dom.H_GEN, words)
        for c in np.nonzero(fb)[0]:
            rows_idx[c] = shactr.choose_k_scalar(
                wt, m, Dom.H_GEN, [m, n, wt, int(c), pk.canon_tag])

    Hbits = np.zeros((n, mw), dtype=U32)
    col_ids = np.repeat(np.arange(n), wt)
    r = rows_idx.reshape(-1)
    np.bitwise_or.at(Hbits, (col_ids, r // 32), U32(1) << (r % 32).astype(U32))
    pk.H = Hbits

    # streaming digest: "H|v2" + m,n,wt (le64) + column bytes
    hsh = hashlib.sha256()
    hsh.update(b"H|v2")
    hsh.update(struct.pack("<QQQ", m, n, wt))
    nbytes = (m + 7) // 8
    full = Hbits.astype("<u4").tobytes()
    if nbytes == mw * 4:
        hsh.update(full)
    else:
        for c in range(n):
            hsh.update(full[c * mw * 4 : c * mw * 4 + nbytes])
    pk.H_digest = hsh.digest()


def prg_layer_ztag(canon_tag: int, nonce: Nonce128) -> int:
    """Layer tag (matrix.hpp:254-264)."""
    msg = Dom.ZTAG.encode() + struct.pack(
        "<QQQ", canon_tag & shactr.U64MAX, nonce.lo & shactr.U64MAX,
        nonce.hi & shactr.U64MAX,
    )
    return struct.unpack("<Q", hashlib.sha256(msg).digest()[:8])[0]


# ---------------------------------------------------------------------------
# σ generation
# ---------------------------------------------------------------------------

def hx_tensor(H: np.ndarray, device=None) -> torch.Tensor:
    """The σ gather table: H rows plus one all-zero row at index n_bits
    (draws that were not taken point there, so the XOR needs no select),
    as an int32 tensor on ``device``."""
    mw = H.shape[1]
    Hx = np.concatenate([H, np.zeros((1, mw), dtype=H.dtype)]).astype(U32)
    return torch.from_numpy(Hx.view(np.int32)).to(device)


def fused_engages(prm, Hx, bit_lo: int = 0) -> bool:
    """Whether :func:`sigma_device` takes the fused launch of kernels B and
    C (crypto/sigma_fused.py): Hx is the whole table on a CUDA device,
    bit_lo is 0 and the card holds the fused kernel's whole grid at once.
    A tp rank's block of columns, a CPU tensor or a grid wider than the
    card takes kernel B, then kernel C (or their twins)."""
    return (bit_lo == 0 and Hx.device.type == "cuda"
            and tuple(Hx.shape) == (prm.n_bits + 1, prm.sigma_words32)
            and sigma_fused.fits(prm, Hx))


def sigma_device(prm, Hx: torch.Tensor, lanes: torch.Tensor, bit_lo: int = 0):
    """The σ program on one device: lanes [E, 7, 2] int32 stream words ->
    (σ [E, mw] int32, fallback [E] bool), both on Hx's device.

    Kernel B draws both SHA-256-CTR streams of every edge and keeps their
    first k unique draws (:func:`taken_indices`, the kernel or its twin);
    kernel C XORs the taken H rows and sets the taken noise bits.  Where
    :func:`fused_engages`, one launch does both (the producers of each
    super-tile's draws beside the consumers of the one before).  Hx may be
    a block of the table's columns whose first bit is ``bit_lo`` (a tp
    rank's share): σ is then that block of every row."""
    if fused_engages(prm, Hx, bit_lo):
        return sigma_fused.sigma_rows_fused_cuda(prm, Hx, lanes)
    ridx, nbit, fb = taken_indices(prm, lanes)
    return sigma_rows(Hx, ridx, nbit, bit_lo), fb


def check_H(prm, H) -> None:
    """Raise unless H [n_bits, mw] (a public key's, or a table without its
    zero row) is there with n_bits columns: the draws index H's rows, and
    kernel C reads them unchecked."""
    if H is None:
        raise ValueError("sigma needs H: load the public key with with_H=True")
    if H.shape[0] != prm.n_bits:
        raise ValueError(f"H has {H.shape[0]} columns but n_bits is {prm.n_bits}: a "
                         f"pk.bin stores no n_bits, so load_pk keeps the default")


def sigma_tensors(prm, Hx: torch.Tensor, words: np.ndarray, chunk: int):
    """words [E, 7] uint64 -> (σ [E, mw] int32, fallback [E] bool) on Hx's
    device, in passes of at most ``chunk`` edges, without synchronising.
    Raises unless H has n_bits columns (:func:`check_H`)."""
    check_H(prm, Hx[:-1])
    sigs, fbs = [], []
    for off in range(0, words.shape[0], chunk):
        s, f = sigma_device(prm, Hx, lanes_from_u64(words[off : off + chunk],
                                                    Hx.device))
        sigs.append(s)
        fbs.append(f)
    if not sigs:
        return (torch.zeros((0, Hx.shape[1]), dtype=torch.int32, device=Hx.device),
                torch.zeros(0, dtype=torch.bool, device=Hx.device))
    return torch.cat(sigs), torch.cat(fbs)


def sigma_words_start(pk: PubKey, ztag, nonce_lo, nonce_hi, idx, ch, salt):
    """Batched sigma_from_H (matrix.hpp:267-303) over E edges, dispatched to
    the attached engine's device (or the CPU).  All arguments after pk are
    arrays [E] (uint64-compatible).  Returns a :class:`SigmaJob`; calling
    it gives [E, m_words32] uint32 packed syndromes on the host."""
    prm = pk.prm
    E = len(ztag)
    words = np.zeros((E, 7), dtype=np.uint64)
    words[:, 0] = pk.canon_tag
    words[:, 1] = ztag
    words[:, 2] = nonce_lo
    words[:, 3] = nonce_hi
    words[:, 4] = idx
    words[:, 5] = ch
    words[:, 6] = salt
    engine = getattr(pk, "_engine", None)
    if engine is not None:
        sig, fb = engine.sigma(words)
    else:
        sig, fb = sigma_tensors(prm, hx_tensor(pk.H), words, SIGMA_CHUNK_CPU)
    return SigmaJob(pk, prm, words, sig, fb)


class SigmaJob:
    """A dispatched σ batch: device-resident (sig, fb) plus the host word
    fields needed for scalar fallback recomputation."""

    __slots__ = ("pk", "prm", "words", "sig", "fb")

    def __init__(self, pk, prm, words, sig, fb):
        self.pk = pk
        self.prm = prm
        self.words = words
        self.sig = sig
        self.fb = fb

    def __len__(self) -> int:
        return int(self.sig.shape[0])

    def __call__(self) -> np.ndarray:
        sig = sigma_to_host(self.sig).copy()
        for e in np.nonzero(self.fb.cpu().numpy())[0]:
            sig[e] = _scalar_sigma_row(self.pk, self.prm, self.words[e])
        return sig


def _scalar_sigma_row(pk, prm, wrow) -> np.ndarray:
    """Reference-exact σ for one edge via the scalar draw path (fallback
    for lanes the vectorized overshoot window couldn't serve)."""
    w = [int(wrow[j]) for j in range(7)]
    c = shactr.choose_k_scalar(prm.x_col_wt, prm.n_bits, Dom.X_SEED, w)
    nn = shactr.choose_k_scalar(prm.err_wt, prm.m_bits, Dom.NOISE, w)
    v = np.bitwise_xor.reduce(pk.H[c], axis=0)
    for rr in nn:
        v[rr // 32] ^= U32(1 << (rr % 32))
    return v


class SigmaFallbackFixer:
    """Deferred fallback patching for dispatched σ jobs whose outputs are
    concatenated (in job order) into one LazySigma base.

    The fallback flags are not read at creation, so producers return
    device-resident σ with no synchronisation; the one flag read happens
    on the first σ materialization.  Flagged lanes (bounded rejection or
    overshoot exhaustion in the vectorized draws, both rare) are then
    recomputed with the reference-exact scalar path and patched into the
    materialized rows.  Rows are in BASE coordinates."""

    __slots__ = ("jobs", "_patches")

    def __init__(self, jobs):
        self.jobs = jobs
        self._patches = None

    def _resolve(self) -> dict:
        if self._patches is None:
            fbs = [j.fb for j in self.jobs]
            cat = (torch.cat(fbs) if len(fbs) > 1 else fbs[0]).cpu().numpy()
            hits = np.nonzero(cat)[0]
            self._patches = {}
            if hits.size:  # rare: the batch's words are gathered only then
                words = np.concatenate([j.words for j in self.jobs])
                job = np.repeat(np.arange(len(self.jobs)), [len(j) for j in self.jobs])
                self._patches = {
                    int(e): _scalar_sigma_row(self.jobs[job[e]].pk,
                                              self.jobs[job[e]].prm, words[e])
                    for e in hits
                }
            # the patches carry everything needed from here on; release the
            # jobs so their device buffers are not pinned by every view
            self.jobs = None
        return self._patches

    def __call__(self, out: np.ndarray, rows: np.ndarray) -> np.ndarray:
        patches = self._resolve()
        if not patches:
            return out
        pr = np.fromiter(patches.keys(), dtype=np.int64)
        hits = np.nonzero(np.isin(rows, pr))[0]
        if hits.size:
            if not out.flags.writeable:
                out = out.copy()
            for i in hits:
                out[i] = patches[int(rows[i])]
        return out


def sigma_deferred(jobs: list[SigmaJob]):
    """Finalize without synchronising: the jobs' σ bases (device-resident,
    unpatched), concatenated with ``torch.cat``, plus a shared
    :class:`SigmaFallbackFixer` and the row indices [E_total] for the
    LazySigma views over that base."""
    base = torch.cat([j.sig for j in jobs]) if len(jobs) > 1 else jobs[0].sig
    rows = np.arange(base.shape[0], dtype=np.int64)
    return base, SigmaFallbackFixer(jobs), rows


def sigma_words(pk: PubKey, ztag, nonce_lo, nonce_hi, idx, ch, salt) -> np.ndarray:
    """Synchronous sigma_words_start: dispatch + finalize in one call."""
    return sigma_words_start(pk, ztag, nonce_lo, nonce_hi, idx, ch, salt)()


def sigma_from_H(pk: PubKey, ztag: int, nonce: Nonce128, idx: int, ch: int,
                 salt: int) -> np.ndarray:
    """One edge's σ (matrix.hpp:267-303) -> [m_words32] uint32; with an
    engine attached, kernels B and C on its device."""
    return sigma_words(pk, *(np.array([v], dtype=np.uint64) for v in (
        ztag, nonce.lo, nonce.hi, idx, ch, salt)))[0]
