"""The sharded homomorphic step over a (dp, tp) mesh of ranks.

Counterpart of the JAX package's parallel/sharding.py:

- ``dp`` splits the PRF lanes: each rank derives the cores of its lanes.
- ``tp`` splits the LPN secret contraction: each rank folds its word
  window of every row (kernel A with a :class:`~..crypto.lpn_ybits.Window`)
  and the partial bits XOR over the tp group (:func:`tp_combine`) before
  kernel E; the rank that owns the noise word adds it and the rejection
  flags.
- The bucketed field sum, the communication pattern of a sharded ct_mul,
  sums 16-bit half limbs per bucket on each rank, then over the dp group
  only (every tp rank of a dp row holds the same cores), and folds the
  sums mod p.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..core.bits import from_np_u32, u32_to_i32
from ..crypto import lpn
from ..crypto.lpn_ybits import Window, full_window, tp_window
from ..mulgrid import _planes_to_limbs
from .mesh import Mesh

U32 = np.uint32


def tp_xor(mesh: Mesh, y: torch.Tensor, rej: torch.Tensor):
    """The XOR over the tp group of the ranks' partial y [n, 4] int32, and
    the OR of their flags rej [n] bool.  Neither NCCL nor gloo reduces by
    XOR, so the bits are summed unpacked (uint8, one byte per bit and one
    for the flag) and taken mod 2, as the JAX package psums its partial
    parities."""
    n = y.shape[0]
    sh = torch.arange(32, dtype=torch.int64, device=y.device)
    bits = ((y.to(torch.int64)[:, :, None] >> sh) & 1).reshape(n, 128)
    buf = torch.cat([bits, rej.to(torch.int64)[:, None]], dim=1).to(torch.uint8)
    dist.all_reduce(buf, group=mesh.tp_group)
    packed = ((buf[:, :128] & 1).to(torch.int64).reshape(n, 4, 32) << sh).sum(dim=-1)
    return u32_to_i32(packed), buf[:, 128] != 0


def tp_combine(mesh: Mesh, window: Window):
    """The ``combine`` of lpn.prf_cores_device for this rank's ``window``:
    :func:`tp_xor` over the tp group where the window is not the whole row,
    None where it is (every tp rank of the dp row then computes the same
    cores)."""
    if window == full_window(window.s_words64):
        return None
    return functools.partial(tp_xor, mesh)


def bucket_sums(mesh: Mesh, R: torch.Tensor, bucket: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """sum mod p of the cores R [n, 4] int64 of every bucket over the dp
    group -> [n_buckets, 4] int64 canonical limbs: the per-bucket sums of
    each 16-bit half limb (int64, exact), an all-reduce over dp, then the
    Mersenne fold of the 16-bit digit planes."""
    halves = torch.stack([R & 0xFFFF, R >> 16], dim=-1).reshape(-1, 8)
    seg = torch.zeros((n_buckets, 8), dtype=torch.int64, device=R.device)
    seg.index_add_(0, bucket, halves)
    dist.all_reduce(seg, group=mesh.dp_group)
    planes = torch.cat([seg.T, seg.new_zeros((3, n_buckets))])
    return _planes_to_limbs(planes)


def multichip_inputs(prm, n_lanes: int, seed: int = 0):
    """The step's global inputs for ``n_lanes`` lanes, from the JAX
    build_inputs' numpy draws: (keys [N, 32] uint8, nlo, nhi [N] uint32,
    tkeys, tnlo, tnhi, s32 [2 * s_words64] uint32, bucket [N] int32).  Raw
    keys and nonce halves take the place of the JAX package's bitsliced
    round keys."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, size=(n_lanes, 32), dtype=np.uint8)
    tkeys = rng.integers(0, 256, size=(n_lanes, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 63, size=(n_lanes,), dtype=np.uint64)
    tnonces = rng.integers(0, 1 << 63, size=(n_lanes,), dtype=np.uint64)
    s32 = rng.integers(0, 1 << 32, size=(2 * prm.s_words64,), dtype=np.uint64).astype(U32)
    bucket = (np.arange(n_lanes) % prm.B).astype(np.int32)
    h = np.stack([nonces, tnonces]).view(U32).reshape(2, n_lanes, 2)  # (lo, hi) halves
    return (keys, h[0, :, 0].copy(), h[0, :, 1].copy(), tkeys, h[1, :, 0].copy(),
            h[1, :, 1].copy(), s32, bucket)


def make_multichip_step(mesh: Mesh, prm, lanes_per_shard: int = 64):
    """The sharded step on this rank's part of ``mesh``.  Returns (step,
    build_inputs) with the JAX make_multichip_step's contract:
    ``build_inputs(seed)`` is :func:`multichip_inputs` of N =
    lanes_per_shard * dp lanes, and ``step(*inputs)``, run on every rank,
    takes this rank's dp lanes and tp window and returns (R [lanes, 4]
    int64 of its dp shard, bucket_sums [B, 4] int64, equal on every rank).
    Where tp does not divide s_words64 the secret stays whole on every
    rank (lpn_ybits.tp_window)."""
    window = tp_window(prm.s_words64, mesh.tp, mesh.tp_rank)
    combine = tp_combine(mesh, window)
    lanes = slice(mesh.dp_rank * lanes_per_shard, (mesh.dp_rank + 1) * lanes_per_shard)
    dev = mesh.device

    def step(keys, nlo, nhi, tkeys, tnlo, tnhi, s32, bucket):
        def u8(a):
            return torch.from_numpy(np.ascontiguousarray(a[lanes])).to(dev)

        def u32(a):
            return from_np_u32(a, dev)

        R, _ = lpn.prf_cores_device(prm, u8(keys), u32(nlo[lanes]), u32(nhi[lanes]), u8(tkeys),
                                    u32(tnlo[lanes]), u32(tnhi[lanes]),
                                    u32(s32[2 * window.lo:2 * window.hi]), window, combine)
        b = torch.from_numpy(bucket[lanes].astype(np.int64)).to(dev)
        return R, bucket_sums(mesh, R, b, prm.B)

    return step, functools.partial(multichip_inputs, prm, lanes_per_shard * mesh.dp)
