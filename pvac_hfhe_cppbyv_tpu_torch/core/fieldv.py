"""Vectorized F_p arithmetic in 4x32-bit limbs, on torch tensors.

p = 2^127 - 1.  A batch of field elements is a tensor [..., 4] of dtype
int64 holding u32 limbs, little-endian (limb k holds bits 32k..32k+31),
canonical value in [0, p).  int64 rather than uint32 because this torch
has no uint32 add, shift or compare; every intermediate below stays under
2^63.  Works on any device.  The semantics mirror
include/pvac/core/field.hpp:50-273 bit-exactly:

- fp_from_words / canonicalization   field.hpp:26-48
- add/sub/neg                        field.hpp:50-71
- 128x128->256 multiply + Mersenne fold fp_reduce256  field.hpp:158-213
- inversion a^(p-2) (Fermat; the reference's windowed chain
  field.hpp:229-269 computes the same value)
"""
from __future__ import annotations

import numpy as np
import torch

from .bits import M32

_M16 = 0xFFFF
_M31 = 0x7FFFFFFF

P_LIMBS = (0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF)


# ---------------------------------------------------------------------------
# conversion helpers
# ---------------------------------------------------------------------------

def from_ints(values, device=None) -> torch.Tensor:
    """Iterable of Python ints (in [0, 2^128)) -> [N, 4] int64 limbs."""
    vals = list(values)
    out = np.empty((len(vals), 4), dtype=np.int64)
    for i, v in enumerate(vals):
        out[i] = (v & M32, (v >> 32) & M32, (v >> 64) & M32, (v >> 96) & M32)
    return torch.from_numpy(out).to(device)


def to_ints(limbs: torch.Tensor) -> list[int]:
    """[..., 4] limbs -> list of Python ints (flattened batch)."""
    rows = limbs.detach().cpu().reshape(-1, 4).tolist()
    return [r[0] | r[1] << 32 | r[2] << 64 | r[3] << 96 for r in rows]


def from_u32(a, device=None) -> torch.Tensor:
    """numpy uint32 limbs [..., 4] -> int64 tensor."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64)).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int64 limb tensor -> numpy uint32 [..., 4]."""
    return t.detach().cpu().numpy().astype(np.uint32)


def from_u64_pairs(lo, hi) -> np.ndarray:
    """(lo, hi) uint64 arrays -> [..., 4] uint32 limbs (host, no reduction)."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return np.stack(
        [
            (lo & np.uint64(M32)).astype(np.uint32),
            (lo >> np.uint64(32)).astype(np.uint32),
            (hi & np.uint64(M32)).astype(np.uint32),
            (hi >> np.uint64(32)).astype(np.uint32),
        ],
        axis=-1,
    )


def to_u64_pairs(limbs) -> tuple[np.ndarray, np.ndarray]:
    """[..., 4] uint32 limbs -> (lo, hi) uint64 arrays (host)."""
    l = np.asarray(limbs, dtype=np.uint32).astype(np.uint64)
    return l[..., 0] | (l[..., 1] << np.uint64(32)), l[..., 2] | (l[..., 3] << np.uint64(32))


# ---------------------------------------------------------------------------
# 128-bit primitive ops
# ---------------------------------------------------------------------------

def _add128(a, b):
    """Full 128-bit add of limb tensors -> (sum limbs, carry out in {0,1})."""
    out = []
    c = torch.zeros_like(a[..., 0])
    for k in range(4):
        t = a[..., k] + b[..., k] + c
        out.append(t & M32)
        c = t >> 32
    return torch.stack(out, dim=-1), c


def _sub128(a, b):
    """Full 128-bit subtract -> (diff limbs, borrow out in {0,1})."""
    out = []
    br = torch.zeros_like(a[..., 0])
    for k in range(4):
        t = a[..., k] - b[..., k] - br
        br = (t < 0).to(torch.int64)
        out.append(t & M32)
    return torch.stack(out, dim=-1), br


def _p_like(a):
    return torch.tensor(P_LIMBS, dtype=torch.int64, device=a.device).expand(a.shape)


def _cond_sub_p(a):
    """a in [0, p]; a - p if a >= p else a."""
    d, br = _sub128(a, _p_like(a))
    return torch.where((br != 0)[..., None], a, d)


def canon(limbs: torch.Tensor) -> torch.Tensor:
    """Canonicalize an arbitrary 128-bit limb vector into [0, p): fold bit
    127, then one conditional subtract (field.hpp:26-48)."""
    extra = limbs[..., 3] >> 31
    a = torch.cat([limbs[..., :3], (limbs[..., 3] & _M31)[..., None]], dim=-1)
    z = torch.zeros_like(extra)
    s, _ = _add128(a, torch.stack([extra, z, z, z], dim=-1))
    return _cond_sub_p(s)


def add(a, b):
    """fp_add (field.hpp:50-56)."""
    s, _ = _add128(a, b)
    return canon(s)


def neg(a):
    """fp_neg (field.hpp:58-67): p - a, canonicalized (p -> 0)."""
    d, _ = _sub128(_p_like(a), a)
    return _cond_sub_p(d)


def sub(a, b):
    """fp_sub = a + (p - b) (field.hpp:69-71)."""
    return add(a, neg(b))


_KIDX = {}


def _kidx(device):
    """Column index i + j of each 16-bit digit product (i, j)."""
    key = str(device)
    if key not in _KIDX:
        i = torch.arange(8)
        _KIDX[key] = (i[:, None] + i[None, :]).reshape(-1).to(device)
    return _KIDX[key]


def _digits16(a):
    return torch.stack([a & _M16, a >> 16], dim=-1).reshape(*a.shape[:-1], 8)


def mul(a, b):
    """fp_mul: 128x128->256 product + Mersenne fold (field.hpp:158-213).

    Schoolbook over 16-bit digits: 64 partial products < 2^32 summed into
    16 columns (< 2^35 each), carry-propagated into 16-bit digits."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (_digits16(a)[..., :, None] * _digits16(b)[..., None, :])
    prod = prod.reshape(*a.shape[:-1], 64)
    acc = torch.zeros(*a.shape[:-1], 16, dtype=torch.int64, device=a.device)
    acc.index_add_(acc.dim() - 1, _kidx(a.device), prod)
    digs = []
    c = torch.zeros_like(acc[..., 0])
    for k in range(16):
        t = acc[..., k] + c
        digs.append(t & _M16)
        c = t >> 16
    z = [digs[2 * k] | (digs[2 * k + 1] << 16) for k in range(8)]
    z.append(torch.zeros_like(z[0]))
    L = torch.stack([z[0], z[1], z[2], z[3] & _M31], dim=-1)
    H = torch.stack(
        [((z[3 + k] >> 31) | (z[4 + k] << 1)) & M32 for k in range(4)], dim=-1)
    x, _ = _add128(L, H)
    return canon(x)


def sqr(a):
    return mul(a, a)


def _pow_2k_mul(x, k, y):
    """x^(2^k) * y."""
    for _ in range(k):
        x = sqr(x)
    return mul(x, y)


def inv(a):
    """a^(p-2), p-2 = (2^125 - 1)*4 + 1, by the addition chain
    1,2,4,8,16,32,64 -> 96 -> 112 -> 120 -> 124 -> 125, then two squarings
    and a multiply.  inv(0) = 0 (the reference never inverts zero)."""
    x1 = a
    x2 = _pow_2k_mul(x1, 1, x1)
    x4 = _pow_2k_mul(x2, 2, x2)
    x8 = _pow_2k_mul(x4, 4, x4)
    x16 = _pow_2k_mul(x8, 8, x8)
    x32 = _pow_2k_mul(x16, 16, x16)
    x64 = _pow_2k_mul(x32, 32, x32)
    x96 = _pow_2k_mul(x64, 32, x32)
    x112 = _pow_2k_mul(x96, 16, x16)
    x120 = _pow_2k_mul(x112, 8, x8)
    x124 = _pow_2k_mul(x120, 4, x4)
    x125 = _pow_2k_mul(x124, 1, x1)
    return _pow_2k_mul(x125, 2, x1)


def canon_u64_limbs(acc: torch.Tensor) -> torch.Tensor:
    """[..., 4] int64 limb accumulators (limb k has weight 2^32k, each a
    non-negative sum < 2^62) -> canonical [..., 4] limbs.  Carry-propagate
    into 128 bits plus an overflow c, then fold 2^128 = 2 (mod p)."""
    limbs = []
    c = torch.zeros_like(acc[..., 0])
    for k in range(4):
        t = acc[..., k] + c
        limbs.append(t & M32)
        c = t >> 32
    x = canon(torch.stack(limbs, dim=-1))
    o = c << 1
    z = torch.zeros_like(o)
    return add(x, canon(torch.stack([o & M32, o >> 32, z, z], dim=-1)))


def is_zero(a):
    """Boolean mask [...] of which elements are zero."""
    return (a[..., 0] | a[..., 1] | a[..., 2] | a[..., 3]) == 0


def select(mask, a, b):
    """Elementwise select: mask broadcast over the limb axis."""
    return torch.where(mask[..., None], a, b)
