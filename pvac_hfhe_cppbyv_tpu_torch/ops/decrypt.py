"""Decryption (reference: include/pvac/ops/decrypt.hpp).

Layer blinding factors resolve over the PROD DAG (BASE layers via one
batched prf_R call on the engine's device); inverses and per-edge terms
are batched limb math; the signed edge sums accumulate per ciphertext and
reduce mod p once.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..core import field as F
from ..core import fieldv as FV
from ..crypto import lpn
from ..types import Cipher, PubKey, SecKey, RRULE_BASE, SGN_P

# Edges per pass of the per-edge limb math (bounds the host working set).
EDGE_CHUNK = 1 << 20


def _resolve_layers(C: Cipher, Rs: list) -> list[int]:
    """Fill PROD layer values as products of their parents (decrypt.hpp:
    12-60).  Raises on parent cycles or out-of-range ids, like the
    reference's abort."""
    L = C.n_layers
    visiting = [False] * L

    def resolve(lid: int) -> int:
        if lid >= L:
            raise ValueError("[R] layer id out of range")
        if Rs[lid] is not None:
            return Rs[lid]
        if visiting[lid]:
            raise ValueError("[R] cycle")
        visiting[lid] = True
        Lr = C.layers[lid]
        R = F.fp_mul(resolve(Lr.pa), resolve(Lr.pb))
        visiting[lid] = False
        Rs[lid] = R
        return R

    for lid in range(L):
        resolve(lid)
    return Rs


def _base_ids(C: Cipher) -> list[int]:
    return [lid for lid in range(C.n_layers) if C.layers[lid].rule == RRULE_BASE]


def _base_seeds(C: Cipher, ids) -> list[list[int]]:
    return [[C.layers[i].seed.ztag, C.layers[i].seed.nonce.lo,
             C.layers[i].seed.nonce.hi] for i in ids]


def layer_R(pk: PubKey, sk: SecKey, C: Cipher) -> list[int]:
    """All layer R values: batched BASE PRFs + DAG products."""
    ids = _base_ids(C)
    Rs: list = [None] * C.n_layers
    if ids:
        vals = FV.to_ints(lpn.prf_R_batch(
            pk, sk, np.array(_base_seeds(C, ids), dtype=np.uint64)))
        for i, v in zip(ids, vals):
            Rs[i] = v
    return _resolve_layers(C, Rs)


def dec_value(pk: PubKey, sk: SecKey, C: Cipher) -> int:
    """dec_value (decrypt.hpp:62-89) -> the field element as a Python int."""
    return dec_value_batch(pk, sk, [C])[0]


def _edge_chunks(cts: list[Cipher]):
    """The edges of all ciphertexts as one stream, in windows of at most
    EDGE_CHUNK edges: yields (ct ids, [(lo, hi)] slices), so no column of
    the whole stream is ever built."""
    starts = np.zeros(len(cts) + 1, dtype=np.int64)
    np.cumsum([C.n_edges for C in cts], out=starts[1:])
    for s in range(0, int(starts[-1]), EDGE_CHUNK):
        e = min(int(starts[-1]), s + EDGE_CHUNK)
        i0 = int(np.searchsorted(starts, s, "right")) - 1
        i1 = int(np.searchsorted(starts, e, "left"))
        ids = [i for i in range(i0, i1) if starts[i + 1] > starts[i]]
        yield ids, [(max(s, starts[i]) - starts[i], min(e, starts[i + 1]) - starts[i])
                    for i in ids]


def dec_value_batch(pk: PubKey, sk: SecKey, cts: list[Cipher]) -> list[int]:
    """Batched decryption: every ciphertext's BASE-layer PRFs run in one
    batch (deduplicated: prf_R is a pure function of the seed), inverses
    in one limb pass, and the edge sums over the flattened edge stream in
    windows of EDGE_CHUNK edges, so a 44 M-edge product keeps a bounded
    working set.

    The signed sums are taken in 16-bit halves of the u32 limbs, so an
    int64 accumulator holds 2^47 addends before it could overflow; no
    ciphertext comes near that.

    Its stages count in the engine's stats (tracing.span): ``ns.dec`` the
    whole call, tiled by ``ns.dec.prf`` (the BASE-layer PRFs, the wait for
    the device included), ``ns.dec.inv`` (layer values and their limb
    inverse), ``ns.dec.sums`` (the edge windows) and ``ns.dec.fold`` (the
    final Python-int fold).  Its counters (tracing.count): ``dec.edges``
    and ``dec.layers``, the edges and layers of the ciphertexts decrypted."""
    with tracing.span(pk, "dec", len(cts)):
        with tracing.span(pk, "dec.prf"):
            spans = [_base_ids(C) for C in cts]
            reqs = [s for C, ids in zip(cts, spans) for s in _base_seeds(C, ids)]
            base_vals: list[int] = []
            if reqs:
                uniq, inv = np.unique(np.asarray(reqs, dtype=np.uint64), axis=0,
                                      return_inverse=True)
                uniq_vals = FV.to_ints(lpn.prf_R_batch(pk, sk, uniq))
                base_vals = [uniq_vals[i] for i in inv.reshape(-1)]

        with tracing.span(pk, "dec.inv"):
            all_Rs = []
            off = 0
            for C, ids in zip(cts, spans):
                Rs: list = [None] * C.n_layers
                for lid in ids:
                    Rs[lid] = base_vals[off]
                    off += 1
                all_Rs.append(_resolve_layers(C, Rs))

            flat = [r for Rs in all_Rs for r in Rs]
            Rinv = (FV.inv(FV.from_ints(flat)) if flat
                    else torch.zeros((0, 4), dtype=torch.int64))
            powg = pk.powg_limbs()
            n_ct = len(cts)
            lstarts = np.zeros(n_ct + 1, dtype=np.int64)
            np.cumsum([len(Rs) for Rs in all_Rs], out=lstarts[1:])

        with tracing.span(pk, "dec.sums"):
            acc = torch.zeros((n_ct * 2, 8), dtype=torch.int64)  # [ct, sign] x halves
            for ids, sls in _edge_chunks(cts):
                w = np.concatenate([cts[i].w[lo:hi] for i, (lo, hi) in zip(ids, sls)])
                idx = np.concatenate([cts[i].idx[lo:hi] for i, (lo, hi) in zip(ids, sls)])
                glid = np.concatenate([lstarts[i] + cts[i].layer_id[lo:hi].astype(np.int64)
                                       for i, (lo, hi) in zip(ids, sls)])
                sgn = np.concatenate([cts[i].ch[lo:hi]
                                      for i, (lo, hi) in zip(ids, sls)]) != SGN_P
                seg = np.repeat(np.asarray(ids, dtype=np.int64) * 2,
                                [hi - lo for lo, hi in sls]) + sgn
                terms = FV.mul(FV.mul(FV.from_u32(w),
                                      powg[torch.from_numpy(idx.astype(np.int64))]),
                               Rinv[torch.from_numpy(glid)])
                halves = torch.stack([terms & 0xFFFF, terms >> 16], dim=-1)
                acc.index_add_(0, torch.from_numpy(seg), halves.reshape(-1, 8))

        with tracing.span(pk, "dec.fold"):
            sums = acc.reshape(n_ct, 2, 8).tolist()
            out = []
            for i in range(n_ct):
                pm = [sum(h << (16 * k) for k, h in enumerate(sums[i][s])) % F.P
                      for s in (0, 1)]
                out.append(F.fp_sub(pm[0], pm[1]))
        tracing.count(pk, {"dec.edges": sum(C.n_edges for C in cts),
                           "dec.layers": int(lstarts[-1])})
    return out
