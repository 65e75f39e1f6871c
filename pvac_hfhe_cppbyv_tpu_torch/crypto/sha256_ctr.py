"""SHA-256-CTR stream states for many lanes, in plain torch.

Lane l with u64 words (w_0 .. w_{n-1}) and counter c hashes
label || le64(w_0) .. le64(w_{n-1}) || le64(c); the result is the final
SHA-256 state [L, R, 8] u32 for c = 0..R-1, the value of the JAX
package's sha256_pallas._shactr_stream_states.  Callers read each state
as four little-endian u64 draws (crypto/shactr.stream_u64s).

This is the host route: the first stage of kernel B's twin
(crypto/sigma_draws.taken_indices_plain) and of the host-side
choose_k_batch.  On the card the σ draws never leave kernel B
(kernels/sigma_draws.cu), so :func:`shactr_states` raises for a tensor
that is not on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import hash as H
from ..core.bits import from_np_u32, i32_to_u32, u32_to_i32


def _layout(label: bytes, n_words: int) -> H.MsgLayout:
    return H.MsgLayout(label, n_words + 1)  # +1 for the counter field


def shactr_states_plain(label: bytes, lanes: torch.Tensor,
                        n_refills: int) -> torch.Tensor:
    """lanes [L, n_words, 2] int32 (lo, hi u32 halves of each stream word)
    -> states [L, n_refills, 8] int32 (u32 bit patterns)."""
    L, n_words = lanes.shape[0], lanes.shape[1]
    layout = _layout(label, n_words)
    dev = lanes.device
    ctr = torch.arange(n_refills, dtype=torch.int64, device=dev)
    ctr_f = torch.stack([ctr, torch.zeros_like(ctr)], dim=-1)  # [R, 2]
    w = i32_to_u32(lanes)[:, None].expand(L, n_refills, n_words, 2)
    c = ctr_f[None, :, None, :].expand(L, n_refills, 1, 2)
    blocks = layout.build_blocks(torch.cat([w, c], dim=2))  # [L, R, nb, 16]
    state = H.sha256_init_state((L, n_refills), dev)
    for b in range(layout.n_blocks):
        state = H.sha256_compress(state, blocks[:, :, b, :])
    return u32_to_i32(state)


def shactr_states(label: bytes, lanes: torch.Tensor,
                  n_refills: int) -> torch.Tensor:
    """:func:`shactr_states_plain` for CPU tensors; raises for any other
    device, where the σ draws run in kernel B."""
    if lanes.device.type == "cpu":
        return shactr_states_plain(label, lanes, n_refills)
    raise ValueError(
        f"SHA-256-CTR states are a host route; on {lanes.device} the σ draws run "
        f"in kernel B (crypto/sigma_draws.taken_indices_cuda, kernels/sigma_draws.cu)")


def lanes_from_u64(words: np.ndarray, device=None) -> torch.Tensor:
    """[L, n_words] uint64 stream words -> [L, n_words, 2] int32 lanes."""
    words = np.ascontiguousarray(words, dtype=np.uint64)
    return from_np_u32(words.view(np.uint32).reshape(*words.shape, 2), device)
