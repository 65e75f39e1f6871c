"""Encryption (reference: include/pvac/ops/encrypt.hpp).

Everything is batched: one prf_cores_batch call covers all (layer, domain,
noise-group) PRF evaluations and one σ dispatch covers all edges, so
encrypting a batch of values costs one pass through each device program.

Host randomness (nonces, index picks, random weights) comes from the OS
CSPRNG exactly like the reference (encrypt.hpp:131-160); the ciphertexts
are therefore differently random but identically distributed, which the
cross-decryption tests check.  Field arithmetic on weights runs as torch
limb math on the host (core/fieldv.py).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import native, tracing
from ..config import dbg
from ..core import bitvec as BV
from ..core import field as F
from ..core import fieldv as FV
from ..core.random import csprng_u64_array
from ..crypto import lpn, matrix
from ..types import (
    Cipher, Dom, Layer, LazySigma, MixedLazySigma, Nonce128, PubKey, RSeed, SecKey,
    StackedSigma, VirtualSigma, RRULE_BASE, RRULE_PROD, SGN_P,
    concat_lazy_sigma, concat_virtual_sigma, make_nonce128, sigma_to_host,
)

U32 = np.uint32
U64MAX = (1 << 64) - 1


def plan_noise(pk: PubKey, depth_hint: int) -> tuple[int, int]:
    """Noise-group budgeting (encrypt.hpp:16-27)."""
    prm = pk.prm
    budget = prm.noise_entropy_bits + prm.depth_slope_bits * max(0, depth_hint)
    per2 = 2.0 * math.log2(float(prm.B))
    per3 = 3.0 * math.log2(float(prm.B))
    z2 = max(0, int(math.floor((budget * prm.tuple2_fraction) / max(1e-6, per2))))
    z3 = max(0, int(math.floor((budget * (1.0 - prm.tuple2_fraction)) / max(1e-6, per3))))
    if z2 + z3 == 1:
        if z3 > 0:
            z3 += 1
        else:
            z2 += 1
    return z2, z3


def sigma_density(pk: PubKey, C: Cipher) -> float:
    """Mean σ bit density (encrypt.hpp:29-37).  A virtual σ streams
    through its rows in chunks and is never held whole."""
    if C.n_edges == 0:
        return 0.0
    if isinstance(C.sigma, VirtualSigma):
        ones = C.sigma.popcnt_total()
    else:
        ones = int(BV.popcnt(sigma_to_host(C.sigma)).sum())
    return ones / float(C.n_edges * pk.prm.m_bits)


def _sigma_host(pk: PubKey, sig) -> np.ndarray:
    """σ rows as a host uint32 array (``sigma_to_host``).  Rows read from a
    device-backed holder (a LazySigma, a MixedLazySigma, a VirtualSigma, a
    tensor) count their bytes in ``sigma.host_bytes`` (tracing.count);
    host rows count nothing."""
    out = sigma_to_host(sig)
    if not isinstance(sig, (np.ndarray, StackedSigma)):
        tracing.count(pk, {"sigma.host_bytes": out.nbytes})
    return out


def _concat_sigma(pk: PubKey, a, b):
    """Concatenate two σ matrices, staying lazy, virtual or on the device
    when possible (views of different σ passes as a MixedLazySigma);
    otherwise both come to the host (``_sigma_host``)."""
    if (isinstance(a, LazySigma) and isinstance(b, LazySigma)
            and a.base is b.base and a.fixup is b.fixup):
        return LazySigma(a.base, np.concatenate([a.rows, b.rows]), a.fixup, a.salt)
    lazy = (LazySigma, MixedLazySigma)
    if isinstance(a, lazy) and isinstance(b, lazy):
        return concat_lazy_sigma([a, b])
    if isinstance(a, VirtualSigma) and isinstance(b, VirtualSigma):
        return concat_virtual_sigma([a, b])
    if isinstance(a, (StackedSigma, np.ndarray)) and isinstance(
            b, (StackedSigma, np.ndarray)) and (
            isinstance(a, StackedSigma) or isinstance(b, StackedSigma)):
        pa = a.parts if isinstance(a, StackedSigma) else [a]
        pb = b.parts if isinstance(b, StackedSigma) else [b]
        return StackedSigma(pa + pb)
    return np.concatenate([_sigma_host(pk, a), _sigma_host(pk, b)])


def _reduce_limb_sums(acc: torch.Tensor) -> np.ndarray:
    """[n, 4] int64 non-negative limb sums -> canonical uint32 limbs."""
    red = native.reduce_u64_limbs(acc.numpy().astype(np.uint64))
    return red if red is not None else FV.to_u32(FV.canon_u64_limbs(acc))


def _permute_edges(C: Cipher, perm: np.ndarray) -> None:
    C.layer_id = C.layer_id[perm]
    C.idx = C.idx[perm]
    C.ch = C.ch[perm]
    C.w = C.w[perm]
    C.sigma = C.sigma[perm]


def compact_edges(pk: PubKey, C: Cipher) -> None:
    """Aggregate edges by (layer, idx, sign): weights sum in F_p, syndromes
    XOR (encrypt.hpp:39-71).  Emission order matches the reference: layer
    ascending, idx ascending, P before M.

    Its counters (tracing.count): ``compact.edges`` the edges in,
    ``compact.buckets`` the edges out (one a kept bucket),
    ``sigma.host_bytes`` the σ bytes it read from the card (0 where σ
    stays there) and ``ns.compact_edges`` its nanoseconds.  That is a
    counter and not a span: the compaction runs under ``sum``,
    ``mul.assemble.compact`` or no span at all (a ct_sub)."""
    E = C.n_edges
    if E == 0:
        return
    t0 = time.perf_counter_ns()
    B = pk.prm.B
    key = (C.layer_id.astype(np.int64) * (2 * B)
           + C.idx.astype(np.int64) * 2 + C.ch.astype(np.int64))
    order = np.argsort(key, kind="stable")
    uniq, start = np.unique(key[order], return_index=True)
    if len(uniq) == E and isinstance(C.sigma, (LazySigma, MixedLazySigma, VirtualSigma)):
        # every bucket is one edge (a product's edges are aggregation
        # outputs, and a sum of products shares no PROD layer): the
        # compaction is a pure reorder and σ stays on the card.  A bucket
        # whose weight and σ are both zero is dropped (encrypt.hpp:60-63);
        # weights are canonical, so only the rows of all-zero weights are
        # read to tell.
        _permute_edges(C, order)
        zero = np.nonzero(~C.w.any(axis=1))[0]
        if zero.size:
            dead = zero[~_sigma_host(pk, C.sigma[zero]).any(axis=1)]
            if dead.size:
                _permute_edges(C, np.delete(np.arange(E), dead))
        tracing.count(pk, {"compact.edges": E, "compact.buckets": C.n_edges,
                           "sigma.host_bytes": 0,
                           "ns.compact_edges": time.perf_counter_ns() - t0})
        return
    sigma = _sigma_host(pk, C.sigma)
    seg = np.zeros(E, dtype=np.int64)
    seg[start] = 1
    seg = np.cumsum(seg) - 1  # bucket id per sorted edge
    acc = torch.zeros((len(uniq), 4), dtype=torch.int64)
    acc.index_add_(0, torch.from_numpy(seg), FV.from_u32(C.w[order]))
    sig = np.zeros((len(uniq), sigma.shape[1]), dtype=U32)
    np.bitwise_xor.at(sig, seg, sigma[order])
    red = _reduce_limb_sums(acc)
    # drop buckets whose weight sum AND σ are both zero (encrypt.hpp:60-63)
    keep = red.any(axis=1) | sig.any(axis=1)
    k = uniq[keep]
    C.layer_id = (k // (2 * B)).astype(np.int32)
    C.idx = ((k // 2) % B).astype(np.int32)
    C.ch = (k & 1).astype(np.int8)
    C.w = red[keep]
    C.sigma = sig[keep]
    tracing.count(pk, {"compact.edges": E, "compact.buckets": len(k),
                       "ns.compact_edges": time.perf_counter_ns() - t0})


def compact_layers(C: Cipher) -> None:
    """Drop unreferenced layers, keeping PROD parents live (encrypt.hpp:73-104).

    Liveness propagates to PROD parents as array gathers (the fixpoint runs
    once per DAG level), and the remap is one cumulative-sum pass."""
    L = C.n_layers
    if L == 0:
        return
    lids = np.unique(C.layer_id)
    if lids.size == L and lids[0] == 0 and lids[-1] == L - 1:
        # every layer is directly referenced by an edge: nothing to drop
        return
    used = np.zeros(L, dtype=bool)
    used[lids[lids < L]] = True
    rules = np.fromiter((Lr.rule for Lr in C.layers), dtype=np.int8, count=L)
    pa = np.fromiter((Lr.pa for Lr in C.layers), dtype=np.int64, count=L)
    pb = np.fromiter((Lr.pb for Lr in C.layers), dtype=np.int64, count=L)
    is_prod = rules == RRULE_PROD
    while True:
        live_prod = used & is_prod
        parents = np.concatenate([pa[live_prod], pb[live_prod]])
        parents = parents[parents < L]
        newly = ~used[parents]
        if not newly.any():
            break
        used[parents[newly]] = True
    if used.all():
        return
    remap = np.cumsum(used) - 1  # new id per old id (valid where used)
    new_layers = [C.layers[i] for i in np.nonzero(used)[0]]
    for Lr in new_layers:
        if Lr.rule == RRULE_PROD:
            Lr.pa = int(remap[Lr.pa])
            Lr.pb = int(remap[Lr.pb])
    C.layers = new_layers
    C.layer_id = remap[C.layer_id].astype(np.int32)


def guard_budget(pk: PubKey, C: Cipher, where: str) -> None:
    """Force compaction past the edge budget (encrypt.hpp:106-111)."""
    if C.n_edges > pk.prm.edge_budget:
        dbg(1, f"[guard] {where}: {C.n_edges} -> compact")
        compact_edges(pk, C)


def prf_noise_delta_seed(base: RSeed, group_id: int, kind: int) -> RSeed:
    """Seed tweak for noise deltas (encrypt.hpp:114-129)."""
    g = (group_id + 1) & U64MAX
    k = (kind + 1) & U64MAX
    lo = base.nonce.lo ^ ((0x9E3779B97F4A7C15 * g) & U64MAX)
    hi = base.nonce.hi ^ ((0x94D049BB133111EB * g) & U64MAX)
    zt = base.ztag ^ ((0x517CC1B727220A95 * g) & U64MAX)
    lo ^= k
    hi ^= (k << 32) & U64MAX
    zt ^= (k << 48) & U64MAX
    return RSeed(ztag=zt, nonce=Nonce128(lo, hi))


def prf_noise_delta(pk: PubKey, sk: SecKey, base_seed: RSeed, group_id: int,
                    kind: int) -> int:
    """prf_R_noise of the tweaked seed (encrypt.hpp:114-129)."""
    return lpn.prf_R_noise(pk, sk, prf_noise_delta_seed(base_seed, group_id, kind))


class _LayerPlan:
    """Host-side plan of one fresh BASE layer: all randomness and index
    choices drawn, PRF requests collected for batching."""

    __slots__ = ("seed", "value", "z2", "z3", "arrs",
                 "skel_idx", "skel_ch", "skel_inv")

    def __init__(self, pk: PubKey, value: int, depth_hint: int):
        nonce = make_nonce128()
        self.seed = RSeed(
            ztag=matrix.prg_layer_ztag(pk.canon_tag, nonce), nonce=nonce
        )
        self.value = value
        self.z2, self.z3 = plan_noise(pk, depth_hint)


def _prf_requests(plan: _LayerPlan) -> list[tuple[RSeed, str]]:
    reqs = [(plan.seed, d) for d in (Dom.PRF_R1, Dom.PRF_R2, Dom.PRF_R3)]
    total = plan.z2 + plan.z3
    for g in range(total):
        if total - g <= 1:
            break
        kind = 0 if g < plan.z2 else 1
        s2 = prf_noise_delta_seed(plan.seed, g, kind)
        for d in (Dom.PRF_NOISE1, Dom.PRF_NOISE2, Dom.PRF_NOISE3):
            reqs.append((s2, d))
    return reqs


def _rand_fp_nonzero_rows(m: int) -> np.ndarray:
    """m uniform nonzero field elements as [m, 4] uint32 limb rows, drawn
    vectorized.  Same per-element distribution as F.rand_fp_nonzero
    (core/types.hpp:145-155): x = hi<<64 | lo with hi < 2^63, rejecting 0
    and P."""
    out = np.empty((m, 4), dtype=U32)
    pending = np.arange(m)
    M32 = np.uint64(0xFFFFFFFF)
    while pending.size:
        k = pending.size
        lo = csprng_u64_array(k)
        hi = csprng_u64_array(k) & np.uint64((1 << 63) - 1)
        bad = ((lo == 0) & (hi == 0)) | (
            (lo == np.uint64(0xFFFFFFFFFFFFFFFF))
            & (hi == np.uint64((1 << 63) - 1))
        )
        out[pending, 0] = (lo & M32).astype(U32)
        out[pending, 1] = (lo >> np.uint64(32)).astype(U32)
        out[pending, 2] = (hi & M32).astype(U32)
        out[pending, 3] = (hi >> np.uint64(32)).astype(U32)
        pending = pending[bad]
    return out


def _mod_draws(m: int, B: int) -> np.ndarray:
    return (csprng_u64_array(m) % np.uint64(B)).astype(np.int64)


def _draw_structures_batch(pk: PubKey, plans: list[_LayerPlan]) -> None:
    """Draw everything PRF-independent for a batch of layers: edge indices,
    signs and the free random weights (encrypt.hpp:162-252), all CSPRNG
    material in bulk getrandom calls.  The scheme depends on each draw's
    distribution, never on draw order.  Fills plan.arrs and the merged
    (idx, ch) edge skeleton, so σ generation can be dispatched before the
    PRF results arrive."""
    B = pk.prm.B
    S = 8
    groups: dict[tuple[int, int], list[int]] = {}
    for t, p in enumerate(plans):
        groups.setdefault((p.z2, p.z3), []).append(t)

    for (z2, z3), ids in groups.items():
        n = len(ids)
        # 8 unique value-edge indices per plan: first-S-unique of a 16-draw
        # window, redrawing the (rare) rows that fall short
        D = 16
        vidx = np.empty((n, S), dtype=np.int64)
        pending = np.arange(n)
        earlier = np.tril(np.ones((D, D), dtype=bool), k=-1)
        while pending.size:
            m = pending.size
            draws = _mod_draws(m * D, B).reshape(m, D)
            dup = (draws[:, :, None] == draws[:, None, :]) & earlier[None]
            first = ~dup.any(-1)
            rank = np.cumsum(first, axis=1)
            ok = rank[:, -1] >= S
            take = first & (rank <= S)
            if ok.any():
                vidx[pending[ok]] = draws[ok][take[ok]].reshape(-1, S)
            pending = pending[~ok]
        vch = (csprng_u64_array(n * S) & np.uint64(1)).astype(np.int64).reshape(n, S)
        vrs = _rand_fp_nonzero_rows(n * (S - 1)).reshape(n, S - 1, 4)

        # z2 pairs: i free, j != i
        if z2:
            i2 = _mod_draws(n * z2, B).reshape(n, z2)
            j2 = _mod_draws(n * z2, B).reshape(n, z2)
            bad = j2 == i2
            while bad.any():
                j2[bad] = _mod_draws(int(bad.sum()), B)
                bad = j2 == i2
            s2a = (csprng_u64_array(n * z2) & np.uint64(1)).astype(np.int64) \
                .reshape(n, z2)
            r2 = _rand_fp_nonzero_rows(n * z2).reshape(n, z2, 4)
        # z3 triples: i free, j != i, k not in {i, j}
        if z3:
            i3 = _mod_draws(n * z3, B).reshape(n, z3)
            j3 = _mod_draws(n * z3, B).reshape(n, z3)
            bad = j3 == i3
            while bad.any():
                j3[bad] = _mod_draws(int(bad.sum()), B)
                bad = j3 == i3
            k3 = _mod_draws(n * z3, B).reshape(n, z3)
            bad = (k3 == i3) | (k3 == j3)
            while bad.any():
                k3[bad] = _mod_draws(int(bad.sum()), B)
                bad = (k3 == i3) | (k3 == j3)
            s3a = (csprng_u64_array(3 * n * z3) & np.uint64(1)) \
                .astype(np.int64).reshape(n, z3, 3)
            ab3 = _rand_fp_nonzero_rows(2 * n * z3).reshape(n, z3, 2, 4)

        # (idx, ch) skeleton + duplicate merge for the whole group: one
        # global unique over plan-offset keys gives each plan its sorted
        # merge table
        cols_i = [vidx]
        cols_c = [vch]
        if z2:
            cols_i.append(np.stack([i2, j2], axis=2).reshape(n, 2 * z2))
            cols_c.append(np.stack([s2a, s2a ^ 1], axis=2).reshape(n, 2 * z2))
        if z3:
            cols_i.append(np.stack([i3, j3, k3], axis=2).reshape(n, 3 * z3))
            cols_c.append(s3a.reshape(n, 3 * z3))
        skel_i_all = np.concatenate(cols_i, axis=1)  # [n, E]
        skel_c_all = np.concatenate(cols_c, axis=1)
        Epp = skel_i_all.shape[1]
        span = 2 * B
        gkey = (skel_i_all * 2 + skel_c_all
                + (np.arange(n, dtype=np.int64) * span)[:, None])
        uniq, inv = np.unique(gkey.reshape(-1), return_inverse=True)
        owner_starts = np.searchsorted(uniq // span, np.arange(n + 1))
        inv2 = inv.reshape(n, Epp)

        for s, t in enumerate(ids):
            plan = plans[t]
            plan.arrs = {
                "vidx": vidx[s], "vch": vch[s], "vrs": vrs[s],
                "i2": i2[s] if z2 else None,
                "j2": j2[s] if z2 else None,
                "s2a": s2a[s] if z2 else None,
                "r2": r2[s] if z2 else None,
                "i3": i3[s] if z3 else None,
                "j3": j3[s] if z3 else None,
                "k3": k3[s] if z3 else None,
                "s3a": s3a[s] if z3 else None,
                "ab3": ab3[s] if z3 else None,
            }
            lo_, hi_ = owner_starts[s], owner_starts[s + 1]
            u = uniq[lo_:hi_] - s * span
            plan.skel_idx = (u // 2).astype(np.int32)
            plan.skel_ch = (u & 1).astype(np.int8)
            plan.skel_inv = (inv2[s] - lo_).astype(np.int64)


def _stack_arr(arrs, key) -> torch.Tensor:
    return torch.from_numpy(np.stack([a[key] for a in arrs]).astype(np.int64))


def _weights_from_cores_batch(pk: PubKey, plans: list[_LayerPlan],
                              cores: torch.Tensor,
                              spans: list[tuple[int, int]]) -> list[np.ndarray]:
    """Edge weights for a whole plan batch (encrypt.hpp:162-252).

    cores is the [N_req, 4] int64 PRF result (request order matching
    spans); returns one [n_merged, 4] uint32 weight array per plan.  The
    per-group fp_inv of the reference becomes a powg table lookup, since g
    has order B: inv(g^i) = g^((B-i) mod B).  Plans are grouped by
    (z2, z3); each group is one [G, E, 4] limb computation."""
    Bmod = pk.prm.B
    gp = pk.powg_limbs()  # [B, 4]
    groups: dict[tuple[int, int], list[int]] = {}
    for t, p in enumerate(plans):
        groups.setdefault((p.z2, p.z3), []).append(t)

    out: list[np.ndarray | None] = [None] * len(plans)
    for (z2, z3), ids in groups.items():
        G = len(ids)
        total = z2 + z3
        nd = max(0, total - 1)
        n_req = 3 + 3 * nd
        offs = torch.tensor([spans[t][0] for t in ids], dtype=torch.int64)
        cg = cores[offs[:, None] + torch.arange(n_req)]  # [G, n_req, 4]
        R = FV.mul(FV.mul(cg[:, 0], cg[:, 1]), cg[:, 2])  # [G, 4]
        A = [plans[t].arrs for t in ids]

        # value edges (8 per layer)
        S = 8
        idxs = _stack_arr(A, "vidx")
        chs = _stack_arr(A, "vch")
        rs_free = FV.from_u32(np.stack([a["vrs"] for a in A]))  # [G, S-1, 4]
        values = FV.from_ints([plans[t].value for t in ids])     # [G, 4]
        terms = FV.mul(rs_free, gp[idxs[:, : S - 1]])
        signed = FV.select(chs[:, : S - 1] == SGN_P, terms, FV.neg(terms))
        sumg = signed[:, 0]
        for j in range(1, S - 1):
            sumg = FV.add(sumg, signed[:, j])
        r_last = FV.mul(FV.sub(values, sumg), gp[(Bmod - idxs[:, S - 1]) % Bmod])
        r_last = FV.select(chs[:, S - 1] == SGN_P, r_last, FV.neg(r_last))
        parts = [torch.cat([rs_free, r_last[:, None]], dim=1)]

        # noise groups 0..total-2 consume the PRF deltas in order; the last
        # closes the telescope with -(sum of them).  plan_noise never
        # returns total == 1.
        if total:
            dd = cg[:, 3:].reshape(G, nd, 3, 4)
            deltas = FV.mul(FV.mul(dd[:, :, 0], dd[:, :, 1]), dd[:, :, 2])
            acc = deltas[:, 0]
            for g in range(1, nd):
                acc = FV.add(acc, deltas[:, g])
            Delta = torch.cat([deltas, FV.neg(acc)[:, None]], dim=1)  # [G, total, 4]

        if z2:
            I2, J2, S1 = _stack_arr(A, "i2"), _stack_arr(A, "j2"), _stack_arr(A, "s2a")
            ri = FV.from_u32(np.stack([a["r2"] for a in A]))  # [G, z2, 4]
            D2 = Delta[:, :z2]
            Dp = FV.select(S1 == SGN_P, D2, FV.neg(D2))
            rj = FV.mul(FV.sub(FV.mul(ri, gp[I2]), Dp), gp[(Bmod - J2) % Bmod])
            parts.append(torch.stack([ri, rj], dim=2).reshape(G, 2 * z2, 4))

        if z3:
            I3, J3, K3 = _stack_arr(A, "i3"), _stack_arr(A, "j3"), _stack_arr(A, "k3")
            sall = _stack_arr(A, "s3a")                       # [G, z3, 3]
            abr = FV.from_u32(np.stack([a["ab3"] for a in A]))  # [G, z3, 2, 4]
            a3, b3 = abr[:, :, 0], abr[:, :, 1]
            t1 = FV.mul(a3, gp[I3])
            t1 = FV.select(sall[..., 0] == SGN_P, t1, FV.neg(t1))
            t2 = FV.mul(b3, gp[J3])
            t2 = FV.select(sall[..., 1] == SGN_P, t2, FV.neg(t2))
            c3 = FV.mul(FV.sub(Delta[:, z2:], FV.add(t1, t2)), gp[(Bmod - K3) % Bmod])
            c3 = FV.select(sall[..., 2] == SGN_P, c3, FV.neg(c3))
            parts.append(torch.stack([a3, b3, c3], dim=2).reshape(G, 3 * z3, 4))

        ws = FV.mul(torch.cat(parts, dim=1), R[:, None])  # [G, E, 4]
        E = ws.shape[1]

        # merge each plan's (idx, ch)-duplicate edges: field sum of members
        counts = [len(plans[t].skel_idx) for t in ids]
        starts = np.concatenate([[0], np.cumsum(counts)])
        glob_inv = np.concatenate(
            [plans[t].skel_inv + starts[s] for s, t in enumerate(ids)])
        acc = torch.zeros((int(starts[-1]), 4), dtype=torch.int64)
        acc.index_add_(0, torch.from_numpy(glob_inv), ws.reshape(G * E, 4))
        red = _reduce_limb_sums(acc)
        for s, t in enumerate(ids):
            out[t] = red[starts[s] : starts[s + 1]]
    return out


def _sigma_for_plans_start(pk: PubKey, plans: list[_LayerPlan]):
    """Dispatch one σ batch covering every merged skeleton edge of every
    planned layer.  Returns finalize() -> (σ base, offsets, fixer, rows,
    salts of the base's rows); the base stays on the device."""
    offsets = np.zeros(len(plans) + 1, dtype=np.int64)
    np.cumsum([len(p.skel_idx) for p in plans], out=offsets[1:])
    counts = np.diff(offsets)
    seeds = np.array([[p.seed.ztag, p.seed.nonce.lo, p.seed.nonce.hi]
                      for p in plans], dtype=np.uint64).reshape(len(plans), 3)
    per_edge = np.repeat(seeds, counts, axis=0)
    idxs = np.concatenate([p.skel_idx for p in plans]).astype(np.uint64)
    chs = np.concatenate([p.skel_ch for p in plans]).astype(np.uint64)
    salt = csprng_u64_array(len(idxs))
    job = matrix.sigma_words_start(
        pk, per_edge[:, 0], per_edge[:, 1], per_edge[:, 2], idxs, chs, salt)

    def finalize():
        base, fixer, rows = matrix.sigma_deferred([job])
        return base, offsets, fixer, rows, salt

    return finalize


def _build_cipher_from_plan(plan: _LayerPlan, weights: np.ndarray,
                            sig) -> Cipher:
    """One single-BASE-layer Cipher from a drawn structure, its merged
    [n, 4] weight limbs and its σ rows."""
    n = len(plan.skel_idx)
    return Cipher([Layer(rule=RRULE_BASE, seed=plan.seed)],
                  np.zeros(n, dtype=np.int32), plan.skel_idx, plan.skel_ch,
                  weights, sig)


def _shuffle_edges(C: Cipher, keys: np.ndarray) -> None:
    """Uniform random edge shuffle (reference: Fisher-Yates,
    encrypt.hpp:155-160): argsort of uniform u64 CSPRNG keys.  Edge order
    is camouflage only; the scheme depends on each edge's distribution,
    never on table order."""
    if C.n_edges > 1:
        _permute_edges(C, np.argsort(keys, kind="stable"))


def _assemble(pk: PubKey, plans: list[_LayerPlan], weights: list[np.ndarray],
              sigma, pair_shares: bool) -> list[Cipher]:
    """The Ciphers of a finalized plan batch: σ views of the batch's σ
    base, each ciphertext's edges shuffled, and with ``pair_shares`` the
    two shares of each value in one two-BASE-layer Cipher."""
    sig_all, offsets, fixer, vrows, salt = sigma
    views = [LazySigma(sig_all, vrows[offsets[i] : offsets[i + 1]], fixer, salt)
             for i in range(len(plans))]
    # one CSPRNG block covers every ciphertext's shuffle keys; edge
    # order is camouflage only (reference: Fisher-Yates,
    # encrypt.hpp:155-160)
    all_keys = csprng_u64_array(int(offsets[-1]))
    out = []
    if not pair_shares:
        for i, p in enumerate(plans):
            C = _build_cipher_from_plan(p, weights[i], views[i])
            guard_budget(pk, C, "enc")
            _shuffle_edges(C, all_keys[offsets[i] : offsets[i + 1]])
            out.append(C)
        return out
    for i in range(0, len(plans), 2):
        pa, pb = plans[i], plans[i + 1]
        perm_a = np.argsort(all_keys[offsets[i] : offsets[i + 1]], kind="stable")
        perm_b = np.argsort(all_keys[offsets[i + 1] : offsets[i + 2]], kind="stable")
        lid = np.zeros(len(perm_a) + len(perm_b), dtype=np.int32)
        lid[len(perm_a):] = 1
        C = Cipher(
            [Layer(rule=RRULE_BASE, seed=pa.seed),
             Layer(rule=RRULE_BASE, seed=pb.seed)],
            lid,
            np.concatenate([pa.skel_idx[perm_a], pb.skel_idx[perm_b]]),
            np.concatenate([pa.skel_ch[perm_a], pb.skel_ch[perm_b]]),
            np.concatenate([weights[i][perm_a], weights[i + 1][perm_b]]),
            _concat_sigma(pk, views[i][perm_a], views[i + 1][perm_b]),
        )
        guard_budget(pk, C, "enc")
        out.append(C)
    return out


def enc_fp_depth_batch_start(pk: PubKey, sk: SecKey, values: list[int],
                             depth_hints: list[int], pair_shares: bool = False):
    """Dispatch half of a batch encryption: the PRF and σ device programs
    are in flight when this returns; the returned finalize() reads the
    cores, computes weights and assembles the Ciphers.

    Each value becomes one single-BASE-layer Cipher (enc_fp_depth,
    encrypt.hpp:162-258).  With ``pair_shares`` consecutive plans
    (2i, 2i+1) are the two shares of one value and assemble directly into
    one two-BASE-layer Cipher, the fused equivalent of per-share Ciphers +
    combine_ciphers (encrypt.hpp:260-279)."""
    if pair_shares and len(values) % 2:
        raise ValueError("shares come in pairs")
    with tracing.span(pk, "enc.plan"):
        plans = [_LayerPlan(pk, v, d) for v, d in zip(values, depth_hints)]
        reqs = []
        spans = []
        for p in plans:
            r = _prf_requests(p)
            spans.append((len(reqs), len(r)))
            reqs.extend(r)
        seeds = np.array(
            [[s.ztag, s.nonce.lo, s.nonce.hi] for s, _ in reqs], dtype=np.uint64)
        dh = np.array([lpn.DOM_HASH[d] for _, d in reqs], dtype=np.uint64)
    dispatch = tracing.span(pk, "enc.dispatch")
    with dispatch:
        prf_fin = lpn.prf_cores_batch_start(pk, sk, seeds, dh)
    with tracing.span(pk, "enc.draw"):
        _draw_structures_batch(pk, plans)
    with dispatch:
        sig_fin = _sigma_for_plans_start(pk, plans)

    def finalize() -> list[Cipher]:
        with tracing.span(pk, "enc.wait"):
            raw = prf_fin()
        with tracing.span(pk, "enc.weights"):
            weights = _weights_from_cores_batch(pk, plans, FV.from_u32(raw), spans)
        with tracing.span(pk, "enc.assemble"):
            return _assemble(pk, plans, weights, sig_fin(), pair_shares)

    return finalize


def combine_ciphers(pk: PubKey, a: Cipher, b: Cipher) -> Cipher:
    """Concatenate layers + edges with layer-id offsetting (encrypt.hpp:260-279)."""
    off = a.n_layers
    layers = [Layer(L.rule, L.seed, L.pa, L.pb) for L in a.layers]
    for L in b.layers:
        if L.rule == RRULE_PROD:
            layers.append(Layer(L.rule, L.seed, L.pa + off, L.pb + off))
        else:
            layers.append(Layer(L.rule, L.seed, L.pa, L.pb))
    C = Cipher(
        layers,
        np.concatenate([a.layer_id, b.layer_id + np.int32(off)]),
        np.concatenate([a.idx, b.idx]),
        np.concatenate([a.ch, b.ch]),
        np.concatenate([a.w, b.w]),
        _concat_sigma(pk, a.sigma, b.sigma),
    )
    guard_budget(pk, C, "combine")
    compact_layers(C)
    return C


def enc_fp_depth_batch(pk: PubKey, sk: SecKey, values: list[int],
                       depth_hints: list[int]) -> list[Cipher]:
    """Single-layer encryptions of field elements, one PRF batch and one
    σ batch for all of them."""
    return enc_fp_depth_batch_start(pk, sk, values, depth_hints)()


def enc_fp_depth(pk: PubKey, sk: SecKey, v: int, depth_hint: int) -> Cipher:
    """enc_fp_depth (encrypt.hpp:162-258)."""
    return enc_fp_depth_batch(pk, sk, [v], [depth_hint])[0]


def enc_value_depth(pk: PubKey, sk: SecKey, v: int, depth_hint: int) -> Cipher:
    """Two-share split v = (v + mask) + (-mask) (encrypt.hpp:281-287)."""
    mask = F.rand_fp_nonzero()
    c1, c2 = enc_fp_depth_batch(pk, sk, [F.fp_add(F.fp_from_u64(v), mask),
                                         F.fp_neg(mask)], [depth_hint] * 2)
    return combine_ciphers(pk, c1, c2)


def enc_value(pk: PubKey, sk: SecKey, v: int) -> Cipher:
    return enc_value_depth(pk, sk, v, 0)


def enc_zero_depth(pk: PubKey, sk: SecKey, depth_hint: int) -> Cipher:
    mask = F.rand_fp_nonzero()
    c1, c2 = enc_fp_depth_batch(pk, sk, [mask, F.fp_neg(mask)], [depth_hint] * 2)
    return combine_ciphers(pk, c1, c2)


def enc_value_batch(pk: PubKey, sk: SecKey, values: list[int],
                    depth_hint: int = 0,
                    pipeline_chunk: int = 1024) -> list[Cipher]:
    """Batched enc_value: value v becomes the two shares (v + mask, -mask)
    (encrypt.hpp:281-287), each a fresh BASE layer.

    Batches beyond ``pipeline_chunk`` values run software-pipelined: chunk
    i+1's PRF and σ device work is dispatched before chunk i's host
    finalize, so host and device work overlap.

    Its stages count in the engine's stats (tracing.span): ``ns.enc`` the
    whole call, tiled by ``ns.enc.plan`` (shares, layer plans, PRF seeds),
    ``ns.enc.dispatch`` (the PRF and σ launches), ``ns.enc.draw`` (edge
    structures), ``ns.enc.wait`` (reading the PRF cores back),
    ``ns.enc.weights`` and ``ns.enc.assemble`` (σ views, shuffles,
    Ciphers), repeated per chunk in host order."""
    def shares_of(vs):
        out = []
        for v in vs:
            val = F.fp_from_u64(v)
            mask = F.rand_fp_nonzero()
            out.append(F.fp_add(val, mask))
            out.append(F.fp_neg(mask))
        return out

    out: list[Cipher] = []
    prev = None  # finalize of the previous chunk
    with tracing.span(pk, "enc", len(values)):
        plan = tracing.span(pk, "enc.plan")
        for off in range(0, len(values), pipeline_chunk):
            vs = values[off : off + pipeline_chunk]
            with plan:
                shares = shares_of(vs)
            fin = enc_fp_depth_batch_start(pk, sk, shares, [depth_hint] * (2 * len(vs)),
                                           pair_shares=True)
            if prev is not None:
                out.extend(prev())
            prev = fin
        if prev is not None:
            out.extend(prev())
    return out

