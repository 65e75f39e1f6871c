"""Recryption and the evaluation key (reference: include/pvac/ops/recrypt.hpp)."""
from __future__ import annotations

from ..core.random import csprng_u64
from ..crypto import matrix
from ..types import Cipher, EvalKey, PubKey, SecKey, VirtualSigma
from .arithmetic import ct_add
from .encrypt import (
    compact_edges, compact_layers, enc_value, enc_zero_depth, guard_budget,
    sigma_density,
)

# A virtual σ of more edges than this decides the balance check on a row
# sample first; below it the exact streamed density is cheap.
VSIGMA_SAMPLE_MIN = 1 << 16


def make_evalkey(pk: PubKey, sk: SecKey, pool_size: int, depth_hint: int) -> EvalKey:
    """Pool of encryptions of zero + enc(1) (recrypt.hpp:12-19)."""
    return EvalKey(
        zero_pool=[enc_zero_depth(pk, sk, depth_hint) for _ in range(pool_size)],
        enc_one=enc_value(pk, sk, 1),
    )


def sigma_needs_balance(pk: PubKey, C: Cipher) -> bool:
    """σ density outside [0.495, 0.505] (recrypt.hpp:21-24).

    A large virtual σ is judged from a 16384-row sample
    (VirtualSigma.density_sample, 3-sigma error below 0.0006); only a
    sampled density inside [0.497, 0.503] or outside [0.493, 0.507] is
    trusted, and one between is checked exactly, so sampling luck cannot
    skip a needed rebalance."""
    if isinstance(C.sigma, VirtualSigma) and C.n_edges > VSIGMA_SAMPLE_MIN:
        d = C.sigma.density_sample()
        if 0.497 <= d <= 0.503:
            return False
        if d < 0.493 or d > 0.507:
            return True
    d = sigma_density(pk, C)
    return d < 0.495 or d > 0.505


def ct_recrypt(pk: PubKey, ek: EvalKey, C: Cipher) -> Cipher:
    """At most 8 rounds of add-zero + ubk permutation + compaction
    (recrypt.hpp:26-41)."""
    if not ek.zero_pool or C.n_edges == 0:
        return C
    result = C.copy()
    it = 0
    while it < 8 and sigma_needs_balance(pk, result):
        result = ct_add(pk, result, ek.zero_pool[csprng_u64() % len(ek.zero_pool)])
        matrix.ubk_apply(pk, result)
        guard_budget(pk, result, "recrypt")
        it += 1
    compact_edges(pk, result)
    compact_layers(result)
    return result
