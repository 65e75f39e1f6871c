"""The σ draws of many edges, from stream words to taken indices: kernel B
and its plain twin.

Edge e with u64 stream words w (lanes [E, n_words, 2] int32 halves) has
two SHA-256-CTR draw streams (crypto/shactr.py): X_SEED draws row indices
mod n_bits and NOISE draws bit positions mod m_bits, k + OVERSHOOT draws
each (k = x_col_wt, err_wt).  Each keeps its first k first occurrences in
stream order (the reference's prg_choose_k, matrix.hpp:15-92).  The
result is what kernel C (crypto/sigma_xor.py) reads:

- ridx [E, x_col_wt]: the taken row draws in stream order, the j-th in
  column j, padded with the zero row n_bits where fewer were taken;
- nbit [E, err_wt + OVERSHOOT]: each noise draw where it is taken, -1
  elsewhere;
- fb [E] bool: a draw of either stream fails the bounded test, or a
  stream's window holds fewer than k first occurrences; the caller
  recomputes those edges with the scalar path.

Indices are int16 where they fit (n_bits < 2^15, m_bits <= 2^15), else
int32.  This is the value of the JAX package's SHA-256-CTR Pallas kernel
plus its draws_and_take (shactr.py), compacted.

:func:`taken_indices` launches kernel B (kernels/sigma_draws.cu: midstate
once per stream, the draws kept in shared memory, a warp-wide dedup
without a sort) for CUDA tensors and runs :func:`taken_indices_plain`
for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..core import hash as H
from ..types import Dom
from . import shactr
from .shactr import OVERSHOOT

_LABELS = (Dom.X_SEED.encode(), Dom.NOISE.encode())


def index_dtypes(prm) -> tuple[torch.dtype, torch.dtype]:
    """The dtypes of ridx and nbit at these Params."""
    return (torch.int16 if prm.n_bits < 1 << 15 else torch.int32,
            torch.int16 if prm.m_bits <= 1 << 15 else torch.int32)


def taken_indices_plain(prm, lanes: torch.Tensor):
    """lanes [E, n_words, 2] int32 stream words -> (ridx, nbit, fb) as in
    the module docstring, through the torch draws of crypto/shactr.py and
    a scatter of the taken row draws into their columns."""
    k = prm.x_col_wt
    cvals, ctake, fb1 = shactr.draws_and_take(k, prm.n_bits, Dom.X_SEED, lanes)
    nvals, ntake, fb2 = shactr.draws_and_take(prm.err_wt, prm.m_bits, Dom.NOISE, lanes)
    rdt, ndt = index_dtypes(prm)
    # the j-th taken draw goes to column j; the rest land in column k, cut off
    dst = torch.where(ctake, torch.cumsum(ctake, dim=-1) - 1, k)
    ridx = torch.full((cvals.shape[0], k + 1), prm.n_bits, dtype=rdt, device=cvals.device)
    ridx.scatter_(1, dst, torch.where(ctake, cvals, prm.n_bits).to(rdt))
    ridx = ridx[:, :k].contiguous()
    nbit = torch.where(ntake, nvals, -1).to(ndt)
    return ridx, nbit, fb1 | fb2


def taken_indices_cuda(prm, lanes: torch.Tensor):
    """Kernel B on CUDA tensors; same contract as the plain twin."""
    dev = kernels.check_cuda(lanes, dtypes=(torch.int32,))
    if lanes.dim() != 3 or lanes.shape[2] != 2 or lanes.shape[1] < 1:
        raise ValueError("expected lanes [E, n_words, 2]")
    for N in (prm.n_bits, prm.m_bits):
        if not 1 <= N < 1 << 16:
            raise ValueError(f"draw modulus out of range: {N}")
    if prm.x_col_wt < 1 or prm.err_wt < 1:
        raise ValueError("x_col_wt and err_wt must be positive")
    E, n_words = lanes.shape[0], lanes.shape[1]
    rdt, ndt = index_dtypes(prm)
    ridx = torch.empty((E, prm.x_col_wt), dtype=rdt, device=dev)
    nbit = torch.empty((E, prm.err_wt + OVERSHOOT), dtype=ndt, device=dev)
    fb = torch.empty(E, dtype=torch.bool, device=dev)
    if E == 0:
        return ridx, nbit, fb
    tmpl, streams = stream_args(prm, n_words)
    kernels.launch("sigma_draws", kernels.lib().pvk_sigma_draws, dev,
                   lanes.data_ptr(), E, n_words, tmpl.ctypes.data, *streams,
                   ridx.data_ptr(), ridx.element_size(), nbit.data_ptr(),
                   nbit.element_size(), fb.data_ptr())
    return ridx, nbit, fb


def stream_args(prm, n_words: int):
    """The message templates of both draw streams for ``n_words`` stream
    words, as a uint32 array in host memory (a launch copies it into the
    kernel's parameters), and the streams' arguments after it: (nb0,
    prefix0, k0, N0, nb1, prefix1, k1, N1, overshoot)."""
    lx, ln = (H.MsgLayout(lb, n_words + 1) for lb in _LABELS)  # +1: the counter
    if max(lx.n_blocks, ln.n_blocks) > 4:
        raise ValueError("σ stream messages longer than 4 blocks")
    tmpl = np.ascontiguousarray(np.concatenate([lx.template_words(), ln.template_words()]),
                                dtype=np.uint32)
    return tmpl, (lx.n_blocks, len(lx.prefix), prm.x_col_wt, prm.n_bits,
                  ln.n_blocks, len(ln.prefix), prm.err_wt, prm.m_bits, OVERSHOOT)


def taken_indices(prm, lanes: torch.Tensor):
    """Kernel B for CUDA tensors, its plain twin for CPU tensors."""
    if lanes.device.type == "cuda":
        return taken_indices_cuda(prm, lanes)
    if lanes.device.type == "cpu":
        return taken_indices_plain(prm, lanes)
    raise ValueError(f"unsupported device {lanes.device}")
