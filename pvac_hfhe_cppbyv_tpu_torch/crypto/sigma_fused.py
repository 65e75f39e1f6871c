"""σ rows from stream words in one launch: kernels B and C fused, and its
plain twin.

lanes [E, n_words, 2] int32 stream words and the whole table Hx
[n_bits + 1, mw] int32 (H and its zero row) -> (σ [E, mw] int32, fb [E]
bool): the value of kernel B (crypto/sigma_draws.py) followed by kernel C
(crypto/sigma_xor.py) with bit_lo = 0, bit for bit.

:func:`sigma_rows_fused_cuda` launches kernels/sigma_fused.cu: one
cooperative launch whose producer warps draw the taken indices of each
super-tile of edges into a ring in device memory, each edge's rows in bank
order, the next super-tile's messages built beside the dedup, while its
consumer warps XOR the H rows of the super-tile before, walking them
staggered, then the noise bits; :func:`sigma_rows_fused_waits` also
returns how long the two roles waited on each other.
:func:`sigma_rows_fused_plain`, its twin, runs B's twin and then C's;
:func:`producer_walks` is the twin of how the producers share the dedup,
:func:`bank_order_plain` and :func:`consumer_walk` of the ring's order and
of the consumers' walk, and :func:`lookup_wavefronts` models what a walk
costs in shared-memory wavefronts.
:func:`fits` says whether the card holds the launch's whole grid at once,
which it needs: crypto/matrix.fused_engages decides the route from it, and
takes B then C where it does not engage, so no CPU tensor reaches here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .shactr import OVERSHOOT
from .sigma_draws import index_dtypes, stream_args, taken_indices_plain
from .sigma_xor import sigma_rows_plain

N_WORDS = 7  # u64 stream words an edge (crypto/matrix.sigma_words_start)


def _ridx_width(prm) -> int:
    """Columns of a ring row: x_col_wt, padded with the zero row to a
    multiple of 16 bytes (the consumers copy rows in 16-byte pieces)."""
    per16 = 16 // torch.tensor([], dtype=index_dtypes(prm)[0]).element_size()
    return -(-prm.x_col_wt // per16) * per16


# plan() by (card, n_bits, m_bits, x_col_wt, err_wt, mw)
_plans: dict[tuple, tuple[int, int, int, int]] = {}


def plan(prm, Hx: torch.Tensor) -> tuple[int, int, int, int]:
    """(CTAs of the fused kernel the card holds at once, slices, most edges
    a super-tile, ring slots) for these Params on Hx's card."""
    dev = Hx.device.index if Hx.device.index is not None else torch.cuda.current_device()
    key = (dev, prm.n_bits, prm.m_bits, prm.x_col_wt, prm.err_wt, Hx.shape[1])
    if key not in _plans:
        rdt, ndt = index_dtypes(prm)
        tmpl, streams = stream_args(prm, N_WORDS)
        out = (ctypes.c_int * 4)()
        rc = kernels.lib().pvk_sigma_fused_plan(
            dev, prm.n_bits + 1, Hx.shape[1], _ridx_width(prm),
            torch.tensor([], dtype=rdt).element_size(), torch.tensor([], dtype=ndt).element_size(),
            N_WORDS, tmpl.ctypes.data, *streams, ctypes.addressof(out))
        if rc != 0:
            raise RuntimeError(f"sigma_fused plan failed: error {rc}")
        _plans[key] = tuple(out)
    return _plans[key]


def fits(prm, Hx: torch.Tensor) -> bool:
    """Whether the card holds one CTA of every slice at once."""
    capacity, n_slices, _, _ = plan(prm, Hx)
    return capacity >= n_slices


def draw_chunk(E: int, n_slices: int, most: int) -> int:
    """Edges each CTA draws per super-tile: ``most``, or half that where
    fewer than four super-tiles would cover the E edges, so that the
    draws of the first super-tile, which nothing overlaps, stay short."""
    return most if E >= 4 * most * n_slices else max(1, most // 2)


def producer_walks(n_here: int, warps: int, most: int = 16) -> list[list[tuple[int, int]]]:
    """Which producer warp of a CTA walks which draw stream in the dedup
    (phase 3) of a chunk of ``n_here`` edges, in the order it walks them
    (the rule in kernels/sigma_fused.cu's header note): stream sid = a most
    + e (a = 0 the rows, a = 1 the noise; ``most`` the kernel's kChunk) goes
    to warp sid mod (warps - 1), where e < n_here, while the last warp
    builds the next chunk's messages and walks none.
    [warp] -> [(a, e)]."""
    walks: list[list[tuple[int, int]]] = [[] for _ in range(warps)]
    for sid in range(2 * most):
        a, e = divmod(sid, most)
        if e < n_here:
            walks[sid % (warps - 1)].append((a, e))
    return walks


def bank_order_plain(ridx: torch.Tensor, sw: int, zero_row: int) -> torch.Tensor:
    """Taken rows ridx [E, w] (kernel B's, padded with ``zero_row``) as
    the fused kernel's producers write them to the ring: each row's taken
    indices grouped by bank key (index mod 32 / sw) in ascending order, in
    draw order within a key, and the padding last."""
    keys = 32 // sw
    key = torch.where(ridx == zero_row, keys, ridx.long() % keys)
    return ridx.gather(1, torch.sort(key, dim=1, stable=True).indices)


def consumer_walk(kp: int, sw: int, staggered: bool = True) -> torch.Tensor:
    """The consumers' staggered walk of a ring row of kp indices (the rule
    in kernels/sigma_fused.cu's header note): [16 // sw, 2, 4 * ceil(kp /
    8)] int64, the row position that thread h of edge j (j = edge mod 16 //
    sw, the edges of one lookup instruction) reads at each of its lookups,
    -1 where it has none left.  ``staggered=False`` gives the walk that
    suits rows in draw order: every thread h from quad h, in steps of 2."""
    nq, group = kp // 4, 16 // sw
    off = 1 if nq % 2 else (nq // 2) | 1
    spread = max(2, nq // (32 // sw))
    walk = torch.full((group, 2, 4 * ((nq + 1) // 2)), -1, dtype=torch.int64)
    for j in range(group):
        for h in range(2):
            q = (j * spread + h * off) % nq if staggered else h
            for t in range((nq + 1 - h) // 2):
                walk[j, h, 4 * t:4 * t + 4] = torch.arange(4 * q, 4 * q + 4)
                q = (q + 2) % nq
    return walk


def lookup_wavefronts(rows: torch.Tensor, walk: torch.Tensor, sw: int) -> float:
    """The mean shared-memory wavefronts of one lookup instruction when the
    consumers walk rows [E, kp] (ring rows, edges in step order) by ``walk``
    ([group, 2, U] as :func:`consumer_walk` gives): each instruction of the
    group's 32 // sw lanes costs the most distinct slice entries that one
    bank key (entry mod 32 / sw) holds among them; lanes at one entry share
    it.  Only whole groups of edges count."""
    group, keys = walk.shape[0], 32 // sw
    n = rows.shape[0] // group
    r = rows[:n * group].long().reshape(n, group, 1, -1)
    idx = walk.clamp(min=0).unsqueeze(0).expand(n, -1, -1, -1)
    addr = r.expand(-1, -1, 2, -1).gather(3, idx)          # [n, group, 2, U]
    addr = torch.where(walk.unsqueeze(0) >= 0, addr, -1)
    addr = addr.permute(0, 3, 1, 2).reshape(n * walk.shape[2], 2 * group)
    addr = torch.sort(addr, dim=1).values
    first = (addr >= 0) & torch.cat([torch.ones_like(addr[:, :1], dtype=torch.bool),
                                     addr[:, 1:] != addr[:, :-1]], dim=1)
    count = torch.zeros(addr.shape[0], keys, dtype=torch.int64)
    count.scatter_add_(1, addr.clamp(min=0) % keys, first.long())
    return float(count.max(dim=1).values.double().mean())


def sigma_rows_fused_plain(prm, Hx: torch.Tensor, lanes: torch.Tensor):
    """The twin: kernel B's twin, then kernel C's."""
    ridx, nbit, fb = taken_indices_plain(prm, lanes)
    return sigma_rows_plain(Hx, ridx, nbit), fb


def sigma_rows_fused_cuda(prm, Hx: torch.Tensor, lanes: torch.Tensor):
    """The fused kernel on CUDA tensors; same contract as the twin.  The
    launch fails where :func:`fits` is false."""
    return _launch(prm, Hx, lanes)[:2]


def sigma_rows_fused_waits(prm, Hx: torch.Tensor, lanes: torch.Tensor):
    """The fused kernel and how long its roles waited on each other: (σ, fb,
    (ready_ns, freed_ns)), the nanoseconds summed over warps that the
    consumer warps spent waiting for the producers' rows (``ready``) and the
    producer warps for a ring slot the consumers still read (``freed``),
    by the card's global timer.  Synchronises the card."""
    out, fb, _, _, _, sync = _launch(prm, Hx, lanes)
    if sync is None:
        return out, fb, (0, 0)
    torch.cuda.synchronize(sync.device)
    ready_ns, freed_ns = sync[-4:].view(torch.int64).tolist()
    return out, fb, (ready_ns, freed_ns)


def sigma_rows_fused_ring(prm, Hx: torch.Tensor, lanes: torch.Tensor):
    """The fused kernel, and the rows its producers wrote to the ring, read
    back as [E, kp] in edge order: (σ, fb, rows).  Only for launches in
    which no ring slot is reused (each group draws at most ``plan()[3]``
    super-tiles: 4096 edges at default Params on an H100)."""
    out, fb, ring, st_edges, groups, _ = _launch(prm, Hx, lanes)
    slots, kp, E = plan(prm, Hx)[3], _ridx_width(prm), lanes.shape[0]
    per_group = -(-(-(-E // st_edges)) // groups)
    if per_group > slots:
        raise ValueError(f"{E} edges take {per_group} super-tiles a group, "
                         f"more than the ring's {slots} slots")
    torch.cuda.synchronize(ring.device)
    rows = ring.view(groups, slots, st_edges, kp)[:, :per_group]
    return out, fb, rows.reshape(-1, kp)[:E]


def _launch(prm, Hx: torch.Tensor, lanes: torch.Tensor):
    """One launch: (σ, fb, the ring, edges a super-tile, groups, the sync
    words: two counters a ring slot and group, then the two wait totals as
    int64)."""
    dev = kernels.check_cuda(Hx, lanes, dtypes=(torch.int32, torch.int32))
    if lanes.dim() != 3 or lanes.shape[1:] != (N_WORDS, 2):
        raise ValueError(f"expected lanes [E, {N_WORDS}, 2]")
    n_rows, mw = Hx.shape
    if n_rows != prm.n_bits + 1 or mw != prm.sigma_words32:
        raise ValueError("the fused kernel takes the whole table: H and its zero row")
    capacity, n_slices, st_max, slots = plan(prm, Hx)
    E = lanes.shape[0]
    rdt, ndt = index_dtypes(prm)
    kp = _ridx_width(prm)
    out = torch.empty((E, mw), dtype=torch.int32, device=dev)
    fb = torch.empty(E, dtype=torch.bool, device=dev)
    if E == 0:
        return out, fb, None, 0, 0, None
    chunk = draw_chunk(E, n_slices, st_max // n_slices)
    st_edges = chunk * n_slices
    groups = max(1, min(capacity // n_slices, -(-E // st_edges)))
    ring = torch.empty(groups * slots * st_edges * kp, dtype=rdt, device=dev)
    nbit = torch.empty((E, prm.err_wt + OVERSHOOT), dtype=ndt, device=dev)
    sync = torch.zeros(groups * 2 * slots + 4, dtype=torch.int32, device=dev)
    tmpl, streams = stream_args(prm, N_WORDS)
    kernels.launch("sigma_fused", kernels.lib().pvk_sigma_fused, dev,
                   Hx.data_ptr(), n_rows, mw, lanes.data_ptr(), E, N_WORDS,
                   tmpl.ctypes.data, *streams, ring.data_ptr(), kp, ring.element_size(),
                   nbit.data_ptr(), nbit.element_size(), fb.data_ptr(), sync.data_ptr(),
                   chunk, groups, out.data_ptr())
    return out, fb, ring, st_edges, groups, sync
