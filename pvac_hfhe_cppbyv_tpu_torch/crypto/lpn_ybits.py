"""The LPN sample bits of prf_R cores: kernel A and its plain twin.

A core is a raw AES-256 key and a 64-bit nonce.  Its AES-256-CTR stream
of u64 words (crypto/aes_ctr.py) is cut into rows of s_words64 + 1 words:
the GF(2) dot product of row r's first s_words64 words with the LPN
secret, XOR the Bernoulli(tau_num / tau_den) noise bit drawn from its
last word, is bit r of y (reference lpn_make_ybits, lpn.hpp:194-233).
Only rows 0..rows-1 are computed (rows <= 127: the ones that reach the
127-bit Toeplitz hash).  A noise word that bounded(tau_den) would reject
flags the core, and its caller recomputes that core exactly.  The JAX
package computes the same bits as its fused Pallas AES kernel plus XLA
parity code (engine prf_program, lpn.cores_from_streams).

A :class:`Window` restricts the parity to positions [lo, hi) of every
row, against the secret's words of that window, and takes the noise word
only where ``noise`` is set: one tp rank's share of the contraction, the
counterpart of the JAX package's lpn.cores_from_streams_tp.  The XOR of
the y of windows that cover every position once, with the noise in one
of them, is the whole row's y.

:func:`lpn_ybits` launches kernel A (kernels/lpn_ybits.cu), which keeps
the keystream on the SM, for CUDA tensors and runs :func:`lpn_ybits_plain`
for CPU tensors.  The twin is aes_ctr.aes_ctr_keystream_plain followed by
:func:`ybits_from_stream`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..core.bits import M32, u32_to_i32
from .aes_ctr import aes_ctr_keystream_plain


def n_stream_blocks(rows: int, s_words64: int) -> int:
    """AES blocks that hold the stream words of rows 0..rows-1."""
    return (rows * (s_words64 + 1) + 1) // 2


class Window(NamedTuple):
    """Positions [lo, hi) of each LPN row of s_words64 + 1 stream words,
    plus the noise word at s_words64 where ``noise`` (then hi =
    s_words64)."""
    s_words64: int
    lo: int
    hi: int
    noise: bool


def full_window(s_words64: int) -> Window:
    """The whole row: every secret word and the noise word."""
    return Window(s_words64, 0, s_words64, True)


def tp_window(s_words64: int, tp: int, tp_rank: int) -> Window:
    """tp rank ``tp_rank``'s window: s_words64 / tp words, the noise word
    on the last rank.  Where tp does not divide s_words64 every rank takes
    the whole row, as the JAX engine keeps the secret replicated unless
    each rank holds whole u64 words (its _s32_tp rule)."""
    if tp == 1 or s_words64 % tp:
        return full_window(s_words64)
    w = s_words64 // tp
    return Window(s_words64, tp_rank * w, (tp_rank + 1) * w, tp_rank == tp - 1)


def window_blocks(rows: int, window: Window) -> int:
    """AES blocks kernel A encrypts per core for ``window``: all of
    :func:`n_stream_blocks` for the whole row, else the (row, block) pairs
    that hold the window's words (a block shared by two rows' windows
    counts once per row)."""
    if window == full_window(window.s_words64):
        return n_stream_blocks(rows, window.s_words64)
    t = window.s_words64 + 1
    end = t if window.noise else window.hi
    return sum((r * t + end - 1) // 2 - (r * t + window.lo) // 2 + 1 for r in range(rows))


def _xor_reduce_last(x: torch.Tensor) -> torch.Tensor:
    """XOR-fold over the last axis (padded to a power of two)."""
    n = x.shape[-1]
    p2 = 1
    while p2 < n:
        p2 *= 2
    if p2 != n:
        x = torch.cat([x, torch.zeros((*x.shape[:-1], p2 - n), dtype=x.dtype,
                                      device=x.device)], dim=-1)
    while x.shape[-1] > 1:
        x = x[..., 0::2] ^ x[..., 1::2]
    return x[..., 0]


def _parity_fold(x: torch.Tensor) -> torch.Tensor:
    """Parity of each 32-bit word (int32 or int64; only bit 0 is read, so
    sign-extending shifts do no harm)."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return (x & 1).to(torch.int64)


def _noise_from_u64(nz_lo: torch.Tensor, nz_hi: torch.Tensor, num: int, den: int):
    """Bernoulli noise bit + bounded-rejection flag from each row's noise
    u64 (lo, hi) halves, int64 u32 values."""
    # bounded(den) < num with strict-< acceptance; den is a power of two in
    # all configurations, so x % den = low bits.
    if den < 1 or den & (den - 1):
        raise ValueError("lpn_tau_den must be a power of two")
    e = ((nz_lo & (den - 1)) < num).to(torch.int64)
    # rejection: x >= 2^64 - den  (lim = 2^64 - den; accept strictly below)
    rej = (nz_hi == M32) & (nz_lo >= (1 << 32) - den)
    return e, rej


def parity_noise_rows(u64s: torch.Tensor, s32: torch.Tensor, rows: int,
                      num: int, den: int, window: Window | None = None):
    """u64s [N, >= rows * (s_words64 + 1), 2] int32 or int64 (lo, hi
    halves of the stream's u64s), s32 the window's LPN secret words
    [2 * (hi - lo)] (the whole secret [2 * s_words64] without a window) ->
    (bits [N, rows] int64: parity XOR noise, rej [N, rows] bool; without
    the noise word, the parity alone and no flag)."""
    N = u64s.shape[0]
    win = window or full_window(s32.shape[0] // 2)
    sw = win.s_words64
    stride = sw + 1
    # row r = u64 stream [r*stride, r*stride + sw), its noise u64 at +sw
    body = u64s[:, : rows * stride].reshape(N, rows, stride, 2)
    w = win.hi - win.lo
    s = s32.reshape(1, 1, w, 2).to(u64s.dtype)
    acc = (body[:, :, win.lo:win.hi] & s).reshape(N, rows, 2 * w)
    dot = _parity_fold(_xor_reduce_last(acc))
    if not win.noise:
        return dot, torch.zeros((N, rows), dtype=torch.bool, device=u64s.device)
    nz = body[:, :, sw].to(torch.int64) & M32
    e, rej = _noise_from_u64(nz[..., 0], nz[..., 1], num, den)
    return dot ^ e, rej


def pack_ybits(bits: torch.Tensor) -> torch.Tensor:
    """bits [N, rows] (0/1, rows <= 128) -> y [N, 4] int32: bit r at word
    r // 32, bit r % 32."""
    N, rows = bits.shape
    cols = []
    for k in range(4):
        lo, hi = 32 * k, min(32 * (k + 1), rows)
        if lo >= rows:
            cols.append(torch.zeros(N, dtype=torch.int64, device=bits.device))
            continue
        sh = torch.arange(hi - lo, dtype=torch.int64, device=bits.device)
        cols.append((bits[:, lo:hi].to(torch.int64) << sh).sum(dim=-1))  # disjoint bits
    return u32_to_i32(torch.stack(cols, dim=-1))


def ybits_from_stream(u64s: torch.Tensor, s32: torch.Tensor, rows: int,
                      num: int, den: int, window: Window | None = None):
    """The parity stage of the twin: stream u64s as in
    :func:`parity_noise_rows` -> (y [N, 4] int32, rej [N] bool)."""
    bits, rej = parity_noise_rows(u64s, s32, rows, num, den, window)
    return pack_ybits(bits), rej.any(dim=-1)


def lpn_ybits_plain(keys: torch.Tensor, nlo: torch.Tensor, nhi: torch.Tensor,
                    s32: torch.Tensor, rows: int, num: int, den: int,
                    window: Window | None = None):
    """keys [N, 32] uint8, nlo/nhi [N] int32 (u32 halves of the nonce), s32
    the window's secret words [2 * (hi - lo)] int32 ([2 * s_words64]
    without a window) -> (y [N, 4] int32, rej [N] bool)."""
    N = keys.shape[0]
    win = window or full_window(s32.shape[0] // 2)
    words = aes_ctr_keystream_plain(keys, nlo, nhi, n_stream_blocks(rows, win.s_words64))
    return ybits_from_stream(words.reshape(N, -1, 2), s32, rows, num, den, win)


def lpn_ybits_cuda(keys: torch.Tensor, nlo: torch.Tensor, nhi: torch.Tensor,
                   s32: torch.Tensor, rows: int, num: int, den: int,
                   window: Window | None = None):
    """Kernel A on CUDA tensors; same contract as the plain twin."""
    dev = kernels.check_cuda(keys, nlo, nhi, s32, dtypes=(
        torch.uint8, torch.int32, torch.int32, torch.int32))
    N = keys.shape[0]
    if keys.shape != (N, 32) or nlo.shape != (N,) or nhi.shape != (N,):
        raise ValueError("expected keys [N, 32], nlo [N], nhi [N]")
    if s32.dim() != 1 or s32.shape[0] < 2 or s32.shape[0] % 2:
        raise ValueError("expected s32 [2 * s_words64]")
    win = window or full_window(s32.shape[0] // 2)
    if not (0 <= win.lo < win.hi <= win.s_words64 and s32.shape[0] == 2 * (win.hi - win.lo)
            and (win.hi == win.s_words64 or not win.noise)):
        raise ValueError(f"bad window {win} for s32 of {s32.shape[0]} words")
    if not 1 <= rows <= 128:
        raise ValueError(f"rows must be in 1..128, got {rows}")
    if den < 1 or den & (den - 1) or den >= 1 << 31 or not 0 <= num < 1 << 31:
        raise ValueError("lpn_tau_den must be a power of two below 2^31")
    if keys.data_ptr() % 16:
        raise ValueError("keys must be 16-byte aligned")
    y = torch.empty((N, 4), dtype=torch.int32, device=dev)
    rej = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return y, rej
    kernels.launch("lpn_ybits", kernels.lib().pvk_lpn_ybits, dev,
                   keys.data_ptr(), nlo.data_ptr(), nhi.data_ptr(), s32.data_ptr(),
                   win.s_words64, win.lo, win.hi, int(win.noise), rows, num, den, N,
                   y.data_ptr(), rej.data_ptr())
    return y, rej


def lpn_ybits(keys: torch.Tensor, nlo: torch.Tensor, nhi: torch.Tensor,
              s32: torch.Tensor, rows: int, num: int, den: int,
              window: Window | None = None):
    """Kernel A for CUDA tensors, its plain twin for CPU tensors."""
    if keys.device.type == "cuda":
        return lpn_ybits_cuda(keys, nlo, nhi, s32, rows, num, den, window)
    if keys.device.type == "cpu":
        return lpn_ybits_plain(keys, nlo, nhi, s32, rows, num, den, window)
    raise ValueError(f"unsupported device {keys.device}")
