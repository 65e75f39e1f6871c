"""Homomorphic arithmetic (reference: include/pvac/ops/arithmetic.hpp).

add, sub, neg, scale and div-const are metadata and limb-vector
operations on the host; σ rows are concatenated, never recomputed.
ct_mul's edge cross product and (layer-pair, idx mod B, sign) bucket
aggregation, the reference's O(|A|·|B|) loop (arithmetic.hpp:79-87), runs
in the native host library (numpy when it is missing), or, for products
too large for it with an engine attached, as the dense-grid convolution
on the engine's device (mulgrid.py).  The σ rows of the product's edges
are then generated in batches on the engine's device, or, past
SIGMA_EAGER_MAX edges, kept as a recipe (types.VirtualSigma).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native, tracing
from ..core import field as F
from ..core import fieldv as FV
from ..core.random import csprng_u64_array
from ..crypto import matrix
from ..types import (
    Cipher, Layer, LazySigma, PubKey, RSeed, StackedSigma, VirtualSigma,
    RRULE_PROD, SGN_M, SGN_P, make_nonce128,
)
from .encrypt import _reduce_limb_sums, combine_ciphers, compact_layers, guard_budget

U32 = np.uint32

# σ lanes per device dispatch of ct_mul_batch: products' edges are pooled
# and sent in whole multiples of this, the remainder once at the end.
SIGMA_DISPATCH = 16384

# At or above this many edge pairs, with an engine attached, a product the
# native aggregator cannot take runs through the device dense grid
# (mulgrid.py), whose cost scales with the layer grid LA*LB*B^2 instead.
MULGRID_PAIR_THRESHOLD = 1 << 20

# Pair cap of the native threaded aggregator.
NATIVE_AGG_PAIR_MAX = 1 << 28

# Grid layer-block size: the grid's device memory grows with LA*LB, so a
# large product runs as blocks of at most MULGRID_LBLOCK x MULGRID_LBLOCK
# occupied layers (the JAX package's size for a 16 GB TPU).
MULGRID_LBLOCK = 32

# Past this many edges a product keeps its σ virtual (types.VirtualSigma,
# generated on first read) instead of generating m_bits per edge.
SIGMA_EAGER_MAX = 1 << 21

# VirtualSigma packs layer ids in 21 bits.
VSIGMA_LAYER_MAX = 1 << 21


def ct_add(pk: PubKey, A: Cipher, B: Cipher) -> Cipher:
    """Concatenation add (arithmetic.hpp:12-31) — same as combine_ciphers."""
    return combine_ciphers(pk, A, B)


def ct_scale(pk: PubKey, A: Cipher, s: int) -> Cipher:
    """Multiply every edge weight by a scalar (arithmetic.hpp:33-37)."""
    C = A.copy()
    sv = FV.from_ints([s % F.P]).expand(C.n_edges, 4)
    C.w = FV.to_u32(FV.mul(FV.from_u32(C.w), sv))
    return C


def ct_scale_batch(pk: PubKey, cts: list[Cipher], ks: list[int]) -> list[Cipher]:
    """Batched ct_scale, equal edge for edge to ``[ct_scale(pk, c, k) for c,
    k in zip(cts, ks)]``: one field multiply across every edge of the batch.
    The outputs share their inputs' index columns and σ (read only, as
    ct_add's StackedSigma shares its parts) and copy their PROD layers, the
    ones compact_layers rewrites.  Timed by the span ``scale``."""
    assert len(cts) == len(ks)
    if not cts:
        return []
    with tracing.span(pk, "scale", len(cts)):
        sizes = [C.n_edges for C in cts]
        sv = FV.from_ints([k % F.P for k in ks]).repeat_interleave(
            torch.tensor(sizes, dtype=torch.int64), dim=0)
        w = FV.to_u32(FV.mul(FV.from_u32(np.concatenate([C.w for C in cts])), sv))
        out, off = [], 0
        for C, n in zip(cts, sizes):
            layers = [Layer(L.rule, L.seed, L.pa, L.pb) if L.rule == RRULE_PROD else L
                      for L in C.layers]
            out.append(Cipher(layers, C.layer_id, C.idx, C.ch, w[off:off + n], C.sigma))
            off += n
    return out


def ct_neg(pk: PubKey, A: Cipher) -> Cipher:
    """Negate every edge weight (arithmetic.hpp:33-37 with s = -1)."""
    C = A.copy()
    C.w = FV.to_u32(FV.neg(FV.from_u32(C.w)))
    return C


def ct_sub(pk: PubKey, A: Cipher, B: Cipher) -> Cipher:
    return ct_add(pk, A, ct_neg(pk, B))


def ct_div_const(pk: PubKey, A: Cipher, k: int) -> Cipher:
    return ct_scale(pk, A, F.fp_inv(k))


def ct_add_batch(pk: PubKey,
                 pairs: list[tuple[Cipher, Cipher]]) -> list[Cipher]:
    """Batched ct_add, equal to ``[ct_add(pk, a, b) for a, b in pairs]``."""
    return _add_batch(pk, pairs, negate_b=False)


def ct_sub_batch(pk: PubKey,
                 pairs: list[tuple[Cipher, Cipher]]) -> list[Cipher]:
    """Batched ct_sub, equal to ``[ct_sub(pk, a, b) for a, b in pairs]``:
    ct_add_batch with every B-side weight negated in one field operation
    across the batch (arithmetic.hpp:43-45)."""
    return _add_batch(pk, pairs, negate_b=True)


def _add_batch(pk: PubKey, pairs: list[tuple[Cipher, Cipher]],
               negate_b: bool) -> list[Cipher]:
    """When every σ is host-resident, the per-pair overhead amortizes: one
    concatenate per edge column across the whole batch, a zero-copy view
    for each output, and σ as a StackedSigma of its inputs.  Otherwise
    (σ on a device) pair by pair, which keeps σ views lazy."""
    if not pairs:
        return []
    hostish = (np.ndarray, StackedSigma)
    if not all(isinstance(a.sigma, hostish) and isinstance(b.sigma, hostish)
               for a, b in pairs):
        if negate_b:
            return [ct_sub(pk, a, b) for a, b in pairs]
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
    if negate_b:
        # parts alternate [a0, b0, a1, b1, ...]: one mask selects every
        # B-side row
        bmask = np.repeat(np.tile(np.array([False, True]), len(pairs)), part_sz)
        w_all[bmask] = FV.to_u32(FV.neg(FV.from_u32(w_all[bmask])))
    out = []
    for i in range(len(pairs)):
        s, e = starts[i], starts[i + 1]
        C = Cipher(layers_list[i], lid_all[s:e], idx_all[s:e], ch_all[s:e],
                   w_all[s:e], sg_parts[i])
        guard_budget(pk, C, "add")
        compact_layers(C)
        out.append(C)
    return out


# ---------------------------------------------------------------------------
# ct_mul
# ---------------------------------------------------------------------------

def _native_agg_viable(LA: int, LB: int, Bmod: int, npairs: int) -> bool:
    if native.lib() is None:
        return False
    keyspace = LA * LB * Bmod * 2
    return 0 < keyspace <= native.CROSS_AGG_KEYSPACE_MAX \
        and npairs <= NATIVE_AGG_PAIR_MAX


def _mul_layers(pk: PubKey, A: Cipher, B: Cipher):
    """PROD layer grid construction (arithmetic.hpp:50-70): A's layers, B's
    (PROD parents shifted), then one fresh PROD layer per (la, lb)."""
    LA, LB = A.n_layers, B.n_layers
    layers = [Layer(L.rule, L.seed, L.pa, L.pb) for L in A.layers]
    off = LA
    for L in B.layers:
        if L.rule == RRULE_PROD:
            layers.append(Layer(L.rule, L.seed, L.pa + off, L.pb + off))
        else:
            layers.append(Layer(L.rule, L.seed, L.pa, L.pb))
    base = len(layers)
    for la in range(LA):
        for lb in range(LB):
            nonce = make_nonce128()
            seed = RSeed(matrix.prg_layer_ztag(pk.canon_tag, nonce), nonce)
            layers.append(Layer(RRULE_PROD, seed, la, off + lb))
    return layers, base


def _layer_table(layers) -> np.ndarray:
    """[L, 3] uint64 (ztag, nonce_lo, nonce_hi) of each layer."""
    return np.array([[L.seed.ztag, L.seed.nonce.lo, L.seed.nonce.hi]
                     for L in layers], dtype=np.uint64).reshape(-1, 3)


def _stage_seed_words(s):
    """Per-edge (ztag, nonce_lo, nonce_hi) of a staged product: every
    product edge lives in a PROD grid layer (lid >= base)."""
    trip = _layer_table(s["layers"][s["base"]:])[s["out_lid"] - s["base"]]
    return trip[:, 0], trip[:, 1], trip[:, 2]


def _stage_dict(layers, base, out_lid, out_idx, out_ch, out_w, route: str,
                pairs: int) -> dict:
    """A staged product's layers and edge columns; ``route`` names what
    aggregated its cross product ("native", "numpy" or "grid"), ``pairs``
    the edge pairs it took (|A| x |B|)."""
    return {"layers": layers, "base": base, "out_lid": out_lid, "out_idx": out_idx,
            "out_ch": out_ch, "out_w": out_w, "route": route, "pairs": pairs}


def _ct_mul_stage_start(pk: PubKey, A: Cipher, B: Cipher):
    """Start staging one product: its layers and the route of its cross
    product.  Returns (layers, base, engine), engine the one to run the
    product's dense grid on, or None for the host aggregator.

    With an engine attached, a product of at least MULGRID_PAIR_THRESHOLD
    edge pairs that the native aggregator cannot take goes to the device
    dense grid; every other product aggregates on the host."""
    LA, LB = A.n_layers, B.n_layers
    npairs = A.n_edges * B.n_edges
    layers, base = _mul_layers(pk, A, B)
    engine = getattr(pk, "_engine", None)
    if (engine is not None and npairs >= MULGRID_PAIR_THRESHOLD
            and not _native_agg_viable(LA, LB, pk.prm.B, npairs)):
        return layers, base, engine
    return layers, base, None


def _ct_mul_stage_cross(pk: PubKey, A: Cipher, B: Cipher, layers, base, engine):
    """The finalize() of a product's aggregated edge columns -> the staged
    dict: the grid's blocks are queued now on ``engine`` and fetched in
    finalize, or with no engine the host aggregates in finalize."""
    if engine is not None:
        return _stage_device(pk, engine, A, B, layers, base)
    return lambda: _ct_mul_stage_host(pk, layers, base, A, B)


def _agg_slots(C: Cipher, Bmod: int):
    """Pre-aggregate edges by slot (layer*2 + sign)*B + idx, the grid
    layout of mulgrid.py: weights field-sum.  Valid before ct_mul because
    the reference's pair key (arithmetic.hpp:81) depends only on each
    edge's slot.  Returns (slots [n] int64 ascending, w [n, 4] uint32)."""
    key = ((C.layer_id.astype(np.int64) * 2 + C.ch) * Bmod
           + C.idx.astype(np.int64))
    uniq, inv = np.unique(key, return_inverse=True)
    acc = torch.zeros((len(uniq), 4), dtype=torch.int64)
    acc.index_add_(0, torch.from_numpy(inv.reshape(-1)), FV.from_u32(C.w))
    return uniq, _reduce_limb_sums(acc)


def _stage_device(pk: PubKey, engine, A: Cipher, B: Cipher, layers, base):
    """Dense-grid staging on the engine's device.  Layer axes are remapped
    to the OCCUPIED layers (empty ones would only pad the grid) and cut
    into blocks of at most MULGRID_LBLOCK; every block is queued now and
    fetched in finalize.  Within a block edges come in (la, lb, c, s)
    order, blocks in (a0, b0) order."""
    LB_all = B.n_layers
    Bmod = pk.prm.B
    npairs = A.n_edges * B.n_edges
    sA, wA = _agg_slots(A, Bmod)
    sB, wB = _agg_slots(B, Bmod)
    occA = np.unique(sA // (2 * Bmod))
    occB = np.unique(sB // (2 * Bmod))
    # slots remapped to occupied-layer rank
    rA = np.searchsorted(occA, sA // (2 * Bmod))
    rB = np.searchsorted(occB, sB // (2 * Bmod))
    relA = rA * 2 * Bmod + sA % (2 * Bmod)
    relB = rB * 2 * Bmod + sB % (2 * Bmod)

    LBLK = MULGRID_LBLOCK
    blocks = []
    for a0 in range(0, len(occA), LBLK):
        a1 = min(len(occA), a0 + LBLK)
        mA = (rA >= a0) & (rA < a1)
        for b0 in range(0, len(occB), LBLK):
            b1 = min(len(occB), b0 + LBLK)
            mB = (rB >= b0) & (rB < b1)
            fin = engine.mulgrid.start(relA[mA] - a0 * 2 * Bmod, wA[mA], a1 - a0,
                                       relB[mB] - b0 * 2 * Bmod, wB[mB], b1 - b0)
            engine.stats["mulgrid_blocks"] += 1
            blocks.append((a0, b0, fin))

    def finalize():
        lids, idxs, chs, ws = [], [], [], []
        for a0, b0, fin in blocks:
            la, lb, c, sg, w = fin()
            lids.append((base + occA[a0 + la] * LB_all + occB[b0 + lb]).astype(np.int32))
            idxs.append(c.astype(np.int32))
            chs.append(sg.astype(np.int8))  # sign axis [SGN_P, SGN_M]
            ws.append(w)
        return _stage_dict(layers, base, np.concatenate(lids), np.concatenate(idxs),
                           np.concatenate(chs), np.concatenate(ws), "grid", npairs)

    return finalize


def _ct_mul_stage_host(pk: PubKey, layers, base, A: Cipher, B: Cipher) -> dict:
    """Host cross-product aggregation: the native aggregator, or numpy
    chunks of A-edges when it is missing or the keyspace is too large."""
    LA, LB = A.n_layers, B.n_layers
    nA, nB = A.n_edges, B.n_edges
    Bmod = pk.prm.B

    got = native.mul_cross_agg(
        A.layer_id, A.idx, A.ch, A.w, B.layer_id, B.idx, B.ch, B.w,
        LA, LB, Bmod,
    )
    if got is not None:
        ks, out_w = got
        route = "native"
    else:
        route = "numpy"
        # chunks of A-edges bound peak memory at ~chunk*nB pair rows; each
        # limb addend is < 2^32, so a bucket's int64 limb sum is exact up
        # to 2^30 edge pairs
        chunk = max(1, (4 << 20) // max(1, nB))
        part_keys, part_accs = [], []
        for a0 in range(0, nA, chunk):
            a1 = min(nA, a0 + chunk)
            ia = np.repeat(np.arange(a0, a1), nB)
            ib = np.tile(np.arange(nB), a1 - a0)
            pair_lid = (A.layer_id[ia].astype(np.int64) * LB
                        + B.layer_id[ib].astype(np.int64))
            idx_sum = (A.idx[ia].astype(np.int64)
                       + B.idx[ib].astype(np.int64)) % Bmod
            key = (pair_lid * Bmod + idx_sum) * 2 + (A.ch[ia] != B.ch[ib])
            ww = FV.mul(FV.from_u32(A.w[ia]), FV.from_u32(B.w[ib]))
            uniq, inv = np.unique(key, return_inverse=True)
            acc = torch.zeros((len(uniq), 4), dtype=torch.int64)
            acc.index_add_(0, torch.from_numpy(inv.reshape(-1)), ww)
            part_keys.append(uniq)
            part_accs.append(acc)
        all_keys = np.concatenate(part_keys) if part_keys else np.zeros(0, np.int64)
        uniq, inv = np.unique(all_keys, return_inverse=True)
        acc = torch.zeros((len(uniq), 4), dtype=torch.int64)
        if part_accs:
            acc.index_add_(0, torch.from_numpy(inv.reshape(-1)), torch.cat(part_accs))
        red = _reduce_limb_sums(acc)
        nz = red.any(axis=1)
        ks, out_w = uniq[nz], red[nz]
    out_lid = (base + (ks // 2) // Bmod).astype(np.int32)
    out_idx = ((ks // 2) % Bmod).astype(np.int32)
    out_ch = np.where((ks & 1) == 0, SGN_P, SGN_M).astype(np.int8)
    return _stage_dict(layers, base, out_lid, out_idx, out_ch, out_w, route, nA * nB)


def _virtual_sigma(pk: PubKey, s: dict) -> VirtualSigma:
    """The recipe of a staged product's σ: its layer seed table, each
    edge's packed (lid, idx, ch) and a fresh salt."""
    packed = ((s["out_lid"].astype(np.uint32) << np.uint32(11))
              | (s["out_idx"].astype(np.uint32) << np.uint32(1))
              | s["out_ch"].astype(np.uint32))
    return VirtualSigma(pk, _layer_table(s["layers"]), packed,
                        csprng_u64_array(len(packed)))


def ct_mul_batch(pk: PubKey, pairs: list[tuple[Cipher, Cipher]]) -> list[Cipher]:
    """Batched ct_mul (arithmetic.hpp:47-106), software-pipelined: every
    device-grid staging is queued first; then each product's host staging
    (cross product and bucket sums) overlaps the device σ generation of the
    edges staged before it.  σ is dispatched in whole multiples of
    SIGMA_DISPATCH lanes pooled across products, the remainder once at the
    end, and stays on the device: each product's σ is a LazySigma view of
    one shared base.  A product of more than SIGMA_EAGER_MAX edges keeps a
    VirtualSigma instead (the reference's eager σ is what kills its own
    depth test at step 4: std::bad_alloc at 44 M edges).

    Its stages count in the engine's stats (tracing.span): ``ns.mul`` the
    whole call, tiled by ``ns.mul.layers`` (the PROD layer grid),
    ``ns.mul.cross`` (the cross product and bucket sums, or the grid's
    dispatch and fetch), ``ns.mul.dispatch`` (σ seed words, salts, pooling
    and launches) and ``ns.mul.assemble`` (σ views, Ciphers, budget and
    layer compaction), of which ``ns.mul.assemble.compact`` is the budget
    and layer compaction.  Its counters (tracing.count): ``mul.pairs`` the
    edge pairs of the cross products (|A| x |B| a product),
    ``mul.route.<route>`` the products each route aggregated (``native``,
    ``numpy``, ``grid``: the staged dict's ``route``) and
    ``mul.layers_dropped`` the layers compaction removed."""
    with tracing.span(pk, "mul", len(pairs)):
        t_cross = tracing.span(pk, "mul.cross")
        t_dispatch = tracing.span(pk, "mul.dispatch")
        staged = []
        pend = []          # per-product (zt, nlo, nhi, idx, ch, salt) blocks
        pend_n = 0
        jobs = []

        def _dispatch(nlanes: int) -> None:
            nonlocal pend, pend_n
            cat = [np.concatenate([b[j] for b in pend]) for j in range(6)]
            jobs.append(matrix.sigma_words_start(pk, *(c[:nlanes] for c in cat)))
            rem = [c[nlanes:] for c in cat]
            pend = [tuple(rem)] if rem[0].size else []
            pend_n = int(rem[0].shape[0])

        with tracing.span(pk, "mul.layers"):
            starts = [_ct_mul_stage_start(pk, A, B) for A, B in pairs]
        with t_cross:
            fins = [_ct_mul_stage_cross(pk, A, B, *st) for (A, B), st in zip(pairs, starts)]
        for fin in fins:
            with t_cross:
                s = fin()
            with t_dispatch:
                staged.append(s)
                n = len(s["out_lid"])
                if n > SIGMA_EAGER_MAX and len(s["layers"]) < VSIGMA_LAYER_MAX:
                    s["vsigma"] = _virtual_sigma(pk, s)
                elif n:
                    pend.append((*_stage_seed_words(s),
                                 s["out_idx"].astype(np.uint64),
                                 s["out_ch"].astype(np.uint64),
                                 csprng_u64_array(n)))
                    pend_n += n
                    if pend_n >= SIGMA_DISPATCH:
                        _dispatch((pend_n // SIGMA_DISPATCH) * SIGMA_DISPATCH)
        with t_dispatch:
            if pend_n:
                _dispatch(pend_n)

        with tracing.span(pk, "mul.assemble"):
            if jobs:
                sig_all, fixer, vrows = matrix.sigma_deferred(jobs)
                # the salt of each row of the σ base, in the jobs' lane order
                salt = np.concatenate([j.words[:, 6] for j in jobs])
            mw = pk.prm.sigma_words32
            out = []
            off = 0
            for s in staged:
                n = len(s["out_lid"])
                if "vsigma" in s:
                    sig = s["vsigma"]
                elif n:
                    sig = LazySigma(sig_all, vrows[off : off + n], fixer, salt)
                    off += n
                else:
                    sig = np.zeros((0, mw), dtype=U32)
                out.append(Cipher(s["layers"], s["out_lid"], s["out_idx"], s["out_ch"],
                                  s["out_w"], sig))
            with tracing.span(pk, "mul.assemble.compact"):
                dropped = 0
                for C in out:
                    n_layers = C.n_layers
                    guard_budget(pk, C, "mul")
                    compact_layers(C)
                    dropped += n_layers - C.n_layers
            routes = [s["route"] for s in staged]
            counts = {f"mul.route.{r}": routes.count(r) for r in set(routes)}
            counts["mul.pairs"] = sum([s["pairs"] for s in staged])
            counts["mul.layers_dropped"] = dropped
            tracing.count(pk, counts)
    return out


def ct_mul(pk: PubKey, A: Cipher, B: Cipher) -> Cipher:
    """Edge cross product with PROD layer grid (arithmetic.hpp:47-106)."""
    return ct_mul_batch(pk, [(A, B)])[0]
