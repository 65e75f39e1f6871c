"""The PRF core from its Toeplitz key and LPN bits: kernel E and its plain
twin.

A prf_R core's 127 LPN bits y (kernel A, crypto/lpn_ybits.py) are hashed
to 127 bits by a GF(2) Toeplitz matrix whose top row is the first
AES-256-CTR block under the core's Toeplitz key and nonce
(toeplitz.hpp:121-140), and that value is mapped to a nonzero element of
F_p, p = 2^127 - 1 (lpn.hpp:25-37).  This is the value of the JAX
package's one-block aes_pallas stream followed by its XLA tail
(lpn.py:384-409: conv127, FV.canon, the nonzero select).

:func:`toep_core` launches kernel E (kernels/toep_core.cu: the key
schedule, the block, the convolution and the field map in registers, one
thread per core) for CUDA tensors and runs :func:`toep_core_plain` for
CPU tensors.  The twin's stages are aes_ctr.round_keys,
aes_ctr.aes_ctr_keystream_rk_plain and :func:`cores_from_ybits`.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..core import fieldv as FV
from ..core.bits import i32_to_u32
from . import toeplitz as TOEP
from .aes_ctr import aes_ctr_keystream_rk_plain, round_keys


def cores_from_ybits(y: torch.Tensor, top_u: torch.Tensor) -> torch.Tensor:
    """LPN bits y [N, 4] int32 (crypto/lpn_ybits) and the first Toeplitz
    block top_u [N, 4] int32 -> prf_R_core field elements [N, 4] int64
    limbs: the 127-bit Toeplitz compression and the map to a nonzero
    element."""
    r = FV.canon(TOEP.conv127(i32_to_u32(y), i32_to_u32(top_u.reshape(-1, 4))))
    one = torch.tensor([1, 0, 0, 0], dtype=torch.int64, device=r.device)
    return FV.select(FV.is_zero(r), one.expand_as(r), r)


def toep_core_plain(tkeys: torch.Tensor, tnlo: torch.Tensor, tnhi: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """tkeys [N, 32] uint8 Toeplitz keys, tnlo/tnhi [N] int32 (u32 halves
    of the Toeplitz nonce), y [N, 4] int32 LPN bits -> r [N, 4] int64
    limbs."""
    return cores_from_ybits(y, aes_ctr_keystream_rk_plain(round_keys(tkeys), tnlo, tnhi, 1))


def toep_core_cuda(tkeys: torch.Tensor, tnlo: torch.Tensor, tnhi: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Kernel E on CUDA tensors; same contract as the plain twin."""
    dev = kernels.check_cuda(tkeys, tnlo, tnhi, y, dtypes=(
        torch.uint8, torch.int32, torch.int32, torch.int32))
    N = tkeys.shape[0]
    if (tkeys.shape != (N, 32) or tnlo.shape != (N,) or tnhi.shape != (N,)
            or y.shape != (N, 4)):
        raise ValueError("expected tkeys [N, 32], tnlo [N], tnhi [N], y [N, 4]")
    if tkeys.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("tkeys and y must be 16-byte aligned")
    r = torch.empty((N, 4), dtype=torch.int64, device=dev)
    if N == 0:
        return r
    kernels.launch("toep_core", kernels.lib().pvk_toep_core, dev,
                   tkeys.data_ptr(), tnlo.data_ptr(), tnhi.data_ptr(),
                   y.data_ptr(), N, r.data_ptr())
    return r


def toep_core(tkeys: torch.Tensor, tnlo: torch.Tensor, tnhi: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """Kernel E for CUDA tensors, its plain twin for CPU tensors."""
    if tkeys.device.type == "cuda":
        return toep_core_cuda(tkeys, tnlo, tnhi, y)
    if tkeys.device.type == "cpu":
        return toep_core_plain(tkeys, tnlo, tnhi, y)
    raise ValueError(f"unsupported device {tkeys.device}")
