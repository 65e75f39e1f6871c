"""ct_mul's cross product as a dense-grid cyclic convolution on the device.

The reference's ct_mul loop (include/pvac/ops/arithmetic.hpp:79-87) sums
edge-pair weights per (layer pair, (idx_a + idx_b) mod B, sign_a XOR
sign_b) key.  The key depends only on each edge's (layer, sign, idx)
slot, so aggregating weights per slot first and combining slots is the
same sum, and the slot-level combine is a batch of length-B cyclic
convolutions over F_p:

    out[la, lb, c, s] = sum_{i, sa} WA[la, sa, i] * WB[lb, sa ^ s, (c - i) mod B]

Field elements split into D7 = 19 digits of 7 bits, so one int8 x int8
product summed over B = 337 terms is below 337 * 127^2 < 2^23 and exact
in int32.  Per B-side digit d2, one int8 matrix product
[LA*2*D7, B] x [B, LB*2*B] (``torch._int_mm``) gives every (A digit,
layer pair, output index) partial sum.  Partial sums of equal digit
weight 2^(7k), k = d1 + d2, add up first (37 sums of at most 19 partial
sums, each below 2^27); each is then folded into 16-bit digit planes at
bit offset 7k mod 127, since 2^127 = 1 (mod p), carried and reduced to
canonical limbs.  Cost scales
with the layer grid LA*LB*B^2, not with the |A|*|B| edge pairs.

Port of the JAX package's parallel/mulgrid.py (XLA code around an int8
``lax.dot_general``, not a Pallas kernel).  The digit product is a plain
library matrix product; the fold is torch int64 arithmetic, vectorized
over the 37 digit weights.  Only the nonzero buckets cross to the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .core import fieldv as FV
from .core.bits import M32, u32_to_i32

D7 = 19            # ceil(128 / 7) digits of 7 bits cover any 128-bit weight
NK = 2 * D7 - 1    # digit weights k = d1 + d2 in [0, 36]
KPAD = 8           # _int_mm on CUDA takes a contraction that is a multiple of 8


def _digits7(W: torch.Tensor) -> torch.Tensor:
    """[..., 4] int64 u32 limbs -> [..., D7] int8 digits of 7 bits."""
    digs = []
    for d in range(D7):
        w0, sh = divmod(7 * d, 32)
        v = W[..., w0] >> sh
        if sh > 32 - 7 and w0 + 1 < 4:
            v = v | (W[..., w0 + 1] << (32 - sh))
        digs.append(v & 0x7F)
    return torch.stack(digs, dim=-1).to(torch.int8)


def _planes_to_limbs(planes: torch.Tensor) -> torch.Tensor:
    """[11, ...] int64 16-bit-digit planes (each below 2^32) -> canonical
    [..., 4] limbs.  value = sum_q planes[q] * 2^(16q); carry-propagate,
    then fold the bits from 128 up with 2^128 = 2 (mod p)."""
    digs = []
    c = torch.zeros_like(planes[0])
    for q in range(11):
        t = planes[q] + c
        digs.append(t & 0xFFFF)
        c = t >> 16
    digs += [c & 0xFFFF, c >> 16]
    l = [digs[2 * m] | (digs[2 * m + 1] << 16) for m in range(6)]
    lo = torch.stack(l[:4], dim=-1)
    z = torch.zeros_like(l[4])
    # bits 128.. are l4 + 2^32 l5; they contribute 2 * (l4 + 2^32 l5)
    hi = torch.stack([(l[4] << 1) & M32, ((l[5] << 1) & M32) | (l[4] >> 31),
                      l[5] >> 31, z], dim=-1)
    return FV.add(FV.canon(lo), FV.canon(hi))


@functools.lru_cache(maxsize=None)
def _conv_table(Bmod: int) -> np.ndarray:
    """Midx[i, c] = (c - i) mod B: the circulant gather pattern."""
    i = np.arange(Bmod)[:, None]
    c = np.arange(Bmod)[None, :]
    return ((c - i) % Bmod).astype(np.int64)


def _fold_tables(device):
    """Per digit weight k: plane index and shift of 2^(7k mod 127)."""
    r = (7 * np.arange(NK)) % 127
    base = torch.from_numpy(r // 16).to(device)
    sh = torch.from_numpy(r % 16).to(device).view(NK, 1, 1, 1)
    return base, sh


def _pad8(n: int) -> int:
    return -(-n // KPAD) * KPAD


def grid_product(Bmod: int, LAp: int, LBp: int, slotsA, wA, slotsB, wB) -> torch.Tensor:
    """The dense-grid product on the tensors' device.

    slots* [n] int64 = (layer*2 + sign)*B + idx, unique per side (edges of
    one slot pre-aggregated); w* [n, 4] int64 canonical limbs.  Layer
    counts LAp, LBp are multiples of 4.  Returns [LAp, LBp, B, 2, 4] int64
    canonical limbs, sign axis [same, different]."""
    dev = wA.device
    K = _pad8(Bmod)

    def densify(slots, w, Lp):
        dense = torch.zeros((Lp * 2 * Bmod, 4), dtype=torch.int64, device=dev)
        dense[slots] = w
        return dense

    WA = densify(slotsA, wA, LAp)
    WB = densify(slotsB, wB, LBp)
    # rows (la, sa, d1), columns i, the contraction zero-padded to K
    A8 = _digits7(WA).view(LAp * 2, Bmod, D7).transpose(1, 2).reshape(LAp * 2 * D7, Bmod)
    A8p = torch.zeros((LAp * 2 * D7, K), dtype=torch.int8, device=dev)
    A8p[:, :Bmod] = A8
    B8 = _digits7(WB).view(LBp * 2, Bmod, D7)
    G = LBp * 2
    MidxT = torch.from_numpy(_conv_table(Bmod).T.copy()).to(dev)   # [c, i]
    S = torch.zeros((NK, LAp * 2, G, Bmod), dtype=torch.int64, device=dev)
    BcT = torch.zeros((G * Bmod, K), dtype=torch.int8, device=dev)
    for d2 in range(D7):
        # the circulant of digit d2, stored transposed ([G*B (c), B (i)]) so
        # the product's second operand is column-major
        BcT[:, :Bmod] = B8[:, :, d2][:, MidxT].reshape(G * Bmod, Bmod)
        Pd = torch._int_mm(A8p, BcT.t()).view(LAp * 2, D7, G, Bmod)
        S[d2 : d2 + D7] += Pd.transpose(0, 1)
    base, sh = _fold_tables(dev)
    planes = torch.zeros((11, LAp * 2, G, Bmod), dtype=torch.int64, device=dev)
    planes.index_add_(0, base, (S << sh) & 0xFFFF)
    planes.index_add_(0, base + 1, (S >> (16 - sh)) & 0xFFFF)
    planes.index_add_(0, base + 2, (S >> (32 - sh)) & 0xFFFF)
    del S
    vals = _planes_to_limbs(planes).view(LAp, 2, LBp, 2, Bmod, 4)
    outP = FV.add(vals[:, 0, :, 0], vals[:, 1, :, 1])   # sa == sb -> +
    outM = FV.add(vals[:, 0, :, 1], vals[:, 1, :, 0])   # sa != sb -> -
    return torch.stack([outP, outM], dim=-2)


def _pad4(n: int) -> int:
    return max(4, -(-n // 4) * 4)


class MulGrid:
    """The dense-grid ct_mul program on one device.

    ``start`` queues one product block on the device and returns its
    finalize(), which copies only the nonzero buckets to the host, so a
    caller queues every block of a large product before reading any."""

    def __init__(self, prm, device):
        self.Bmod = prm.B
        self.device = torch.device(device)

    def start(self, slotsA, wA, LA: int, slotsB, wB, LB: int):
        """slots* [n] (unique per side) and w* [n, 4] uint32 host arrays of
        pre-aggregated edges.  finalize() -> (la, lb, c, s, w): the nonzero
        buckets in (la, lb, c, s) row-major order, w [n, 4] uint32."""
        dev = self.device

        def put(slots, w):
            return (torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(dev),
                    FV.from_u32(w, dev))

        out = grid_product(self.Bmod, _pad4(LA), _pad4(LB), *put(slotsA, wA),
                           *put(slotsB, wB))[:LA, :LB]

        def finalize():
            flat = out.reshape(-1, 4)
            nz = torch.nonzero(flat.ne(0).any(dim=1)).squeeze(1)
            w = u32_to_i32(flat[nz]).cpu().numpy()
            la, rem = np.divmod(nz.cpu().numpy(), LB * self.Bmod * 2)
            lb, rem = np.divmod(rem, self.Bmod * 2)
            c, s = np.divmod(rem, 2)
            return la, lb, c, s, w.view(np.uint32)

        return finalize
