"""Homomorphic add, subtract and negate (reference:
include/pvac/ops/arithmetic.hpp:12-45).

These are metadata and limb-vector operations on the host; σ rows are
concatenated, never recomputed.  ct_mul is not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..core import fieldv as FV
from ..types import Cipher, Layer, PubKey, StackedSigma, RRULE_PROD
from .encrypt import combine_ciphers, compact_layers, guard_budget


def ct_add(pk: PubKey, A: Cipher, B: Cipher) -> Cipher:
    """Concatenation add (arithmetic.hpp:12-31) — same as combine_ciphers."""
    return combine_ciphers(pk, A, B)


def ct_neg(pk: PubKey, A: Cipher) -> Cipher:
    """Negate every edge weight (arithmetic.hpp:33-37 with s = -1)."""
    C = A.copy()
    C.w = FV.to_u32(FV.neg(FV.from_u32(C.w)))
    return C


def ct_sub(pk: PubKey, A: Cipher, B: Cipher) -> Cipher:
    return ct_add(pk, A, ct_neg(pk, B))


def ct_add_batch(pk: PubKey,
                 pairs: list[tuple[Cipher, Cipher]]) -> list[Cipher]:
    """Batched ct_add, equal to ``[ct_add(pk, a, b) for a, b in pairs]``.

    When every σ is host-resident, the per-pair overhead amortizes: one
    concatenate per edge column across the whole batch, a zero-copy view
    for each output, and σ as a StackedSigma of its inputs."""
    if not pairs:
        return []
    hostish = (np.ndarray, StackedSigma)
    if not all(isinstance(a.sigma, hostish) and isinstance(b.sigma, hostish)
               for a, b in pairs):
        return [ct_add(pk, a, b) for a, b in pairs]
    lid_parts, idx_parts, ch_parts, w_parts, sg_parts = [], [], [], [], []
    layers_list, sizes, part_off, part_sz = [], [], [], []
    for a, b in pairs:
        off = len(a.layers)
        # BASE Layer objects are never mutated and safe to share; PROD
        # layers get pa/pb rewritten by compact_layers, so copy them.
        al = [Layer(L.rule, L.seed, L.pa, L.pb) if L.rule == RRULE_PROD else L
              for L in a.layers]
        bl = [Layer(L.rule, L.seed, L.pa + off, L.pb + off)
              if L.rule == RRULE_PROD else L for L in b.layers]
        layers_list.append(al + bl)
        na, nb = a.n_edges, b.n_edges
        lid_parts += [a.layer_id, b.layer_id]
        part_off += [0, off]
        part_sz += [na, nb]
        idx_parts += [a.idx, b.idx]
        ch_parts += [a.ch, b.ch]
        w_parts += [a.w, b.w]
        sa = a.sigma.parts if isinstance(a.sigma, StackedSigma) else [a.sigma]
        sb = b.sigma.parts if isinstance(b.sigma, StackedSigma) else [b.sigma]
        sg_parts.append(StackedSigma(sa + sb))
        sizes.append(na + nb)
    starts = np.zeros(len(pairs) + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    lid_all = np.concatenate(lid_parts) + np.repeat(
        np.asarray(part_off, dtype=np.int32), part_sz).astype(np.int32)
    idx_all = np.concatenate(idx_parts)
    ch_all = np.concatenate(ch_parts)
    w_all = np.concatenate(w_parts)
    out = []
    for i in range(len(pairs)):
        s, e = starts[i], starts[i + 1]
        C = Cipher(layers_list[i], lid_all[s:e], idx_all[s:e], ch_all[s:e],
                   w_all[s:e], sg_parts[i])
        guard_budget(pk, C, "add")
        compact_layers(C)
        out.append(C)
    return out
