"""σ rows from the taken H rows and noise bits: kernel C and its plain twin.

For each edge e: the XOR of the rows Hx[ridx[e, j]] over its k taken row
draws (a lane flagged for the scalar fallback may have
fewer and is padded with the all-zero last row of Hx), then bit nbit[e, j] is flipped
for every noise draw with nbit[e, j] >= 0 (draws not taken are -1).
Taken noise draws are unique per edge, so their bits are disjoint (XOR ==
OR == sum).  Indices are int16 where they fit (n_bits < 2^15 rows,
m_bits <= 2^15 bits), else int32.  This is the H gather-XOR of the JAX
engine's _sigma_from_lanes plus the value of its one-hot noise kernel
(onehot_pallas.onehot_noise_words).

Hx may be a block of columns of the table, Hx[:, c0:c1] (a tp rank's
share, as the JAX engine places H with P(None, "tp")): the output is then
that block of every σ row, and a noise bit b lands at bit b - bit_lo of it,
bit_lo = 32 c0, where that lies in the block; the others are skipped.

:func:`sigma_rows` launches the CUDA kernel (kernels/sigma.cu: the row XOR
from H column slices in shared memory, then the noise bits) for CUDA
tensors and runs :func:`sigma_rows_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..core.bits import u32_to_i32

_INDEX_TYPES = (torch.int16, torch.int32)


def sigma_rows_plain(Hx: torch.Tensor, ridx: torch.Tensor,
                     nbit: torch.Tensor, bit_lo: int = 0) -> torch.Tensor:
    """Hx [n_rows, mw] int32 (the table, or a block of its columns whose
    first bit is bit_lo); ridx [E, k] int16/int32 row indices; nbit [E, dn]
    int16/int32 noise bit positions, -1 for none -> σ [E, mw] int32."""
    E, mw = ridx.shape[0], Hx.shape[1]
    sig = torch.zeros((E, mw), dtype=torch.int32, device=Hx.device)
    ri = ridx.to(torch.int64)
    for j in range(ridx.shape[1]):
        sig ^= Hx.index_select(0, ri[:, j])
    nb = nbit.to(torch.int64) - bit_lo
    taken = (nbit >= 0) & (nb >= 0) & (nb < 32 * mw)
    word = torch.where(taken, nb >> 5, 0)
    mask = torch.where(taken, 1 << (nb & 31), 0)
    noise = torch.zeros((E, mw), dtype=torch.int64, device=Hx.device)
    noise.scatter_add_(1, word, mask)
    return sig ^ u32_to_i32(noise)


def sigma_rows_cuda(Hx: torch.Tensor, ridx: torch.Tensor,
                    nbit: torch.Tensor, bit_lo: int = 0) -> torch.Tensor:
    """Kernel C on CUDA tensors; same contract as the plain twin."""
    dev = kernels.check_cuda(Hx, dtypes=(torch.int32,))
    for t in (ridx, nbit):
        if t.device != dev or t.dtype not in _INDEX_TYPES or t.dim() != 2:
            raise ValueError(f"expected int16 or int32 [E, *] indices on {dev}")
    if not Hx.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    E, k = ridx.shape
    n_rows, mw = Hx.shape
    if nbit.shape[0] != E:
        raise ValueError("ridx and nbit must have one row per edge")
    if bit_lo < 0:
        raise ValueError(f"bit_lo must not be negative, got {bit_lo}")
    # the kernel copies an edge's indices in 16-byte pieces: pad k with
    # the zero row
    per16 = 16 // ridx.element_size()
    if k % per16 or k == 0:
        ridx = torch.cat([ridx, ridx.new_full((E, per16 - k % per16), n_rows - 1)], dim=1)
    ridx, nbit = ridx.contiguous(), nbit.contiguous()
    if ridx.data_ptr() % 16:
        raise ValueError("ridx must be 16-byte aligned")
    out = torch.empty((E, mw), dtype=torch.int32, device=dev)
    if E == 0:
        return out
    kernels.launch("sigma", kernels.lib().pvk_sigma, dev,
                   Hx.data_ptr(), n_rows, mw, ridx.data_ptr(), ridx.shape[1],
                   ridx.element_size(), nbit.data_ptr(), nbit.shape[1],
                   nbit.element_size(), bit_lo, E, out.data_ptr())
    return out


def sigma_rows(Hx: torch.Tensor, ridx: torch.Tensor,
               nbit: torch.Tensor, bit_lo: int = 0) -> torch.Tensor:
    """Kernel C for CUDA tensors, its plain twin for CPU tensors."""
    if Hx.device.type == "cuda":
        return sigma_rows_cuda(Hx, ridx, nbit, bit_lo)
    if Hx.device.type == "cpu":
        return sigma_rows_plain(Hx, ridx, nbit, bit_lo)
    raise ValueError(f"unsupported device {Hx.device}")
