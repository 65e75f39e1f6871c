"""σ rows from selected H rows and noise bits: kernel C and its plain twin.

For each edge e: XOR of the rows Hx[cidx[e, j]] (draws not taken point at
the all-zero row appended to H), then draw j's noise mask nmask[e, j] is
XORed into word nword[e, j].  Taken noise draws are unique per edge, so
their bits are disjoint (XOR == OR == sum), and draws not taken carry a
zero mask.  This is the H gather-XOR of the JAX engine's
_sigma_from_lanes plus the value of its one-hot noise kernel
(onehot_pallas.onehot_noise_words).

:func:`sigma_rows` launches the CUDA kernel (kernels/sigma.cu) for CUDA
tensors and runs :func:`sigma_rows_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..core.bits import i32_to_u32, u32_to_i32


def sigma_rows_plain(Hx: torch.Tensor, cidx: torch.Tensor, nword: torch.Tensor,
                     nmask: torch.Tensor) -> torch.Tensor:
    """Hx [n_rows, mw] int32; cidx [E, dc] int32; nword [E, dn] int32;
    nmask [E, dn] int32 (u32 bit masks) -> σ [E, mw] int32."""
    E, mw = cidx.shape[0], Hx.shape[1]
    sig = torch.zeros((E, mw), dtype=torch.int32, device=Hx.device)
    ci = cidx.to(torch.int64)
    for j in range(cidx.shape[1]):
        sig ^= Hx.index_select(0, ci[:, j])
    noise = torch.zeros((E, mw), dtype=torch.int64, device=Hx.device)
    noise.scatter_add_(1, nword.to(torch.int64), i32_to_u32(nmask))
    return sig ^ u32_to_i32(noise)


def sigma_rows_cuda(Hx: torch.Tensor, cidx: torch.Tensor, nword: torch.Tensor,
                    nmask: torch.Tensor) -> torch.Tensor:
    """Kernel C on CUDA tensors; same contract as the plain twin."""
    dev = kernels.check_cuda(Hx, cidx, nword, nmask, dtypes=(torch.int32,) * 4)
    E, dc = cidx.shape
    dn = nword.shape[1]
    mw = Hx.shape[1]
    if nword.shape != (E, dn) or nmask.shape != (E, dn):
        raise ValueError("expected nword and nmask of shape [E, dn]")
    out = torch.empty((E, mw), dtype=torch.int32, device=dev)
    if E == 0:
        return out
    kernels.launch("sigma", kernels.lib().pvk_sigma, dev,
                   Hx.data_ptr(), mw, cidx.data_ptr(), dc, nword.data_ptr(),
                   nmask.data_ptr(), dn, E, out.data_ptr())
    return out


def sigma_rows(Hx: torch.Tensor, cidx: torch.Tensor, nword: torch.Tensor,
               nmask: torch.Tensor) -> torch.Tensor:
    """Kernel C for CUDA tensors, its plain twin for CPU tensors."""
    if Hx.device.type == "cuda":
        return sigma_rows_cuda(Hx, cidx, nword, nmask)
    if Hx.device.type == "cpu":
        return sigma_rows_plain(Hx, cidx, nword, nmask)
    raise ValueError(f"unsupported device {Hx.device}")
