"""Metrics and diagnostics (reference: include/pvac/utils/metrics.hpp)."""
from __future__ import annotations

import numpy as np

from ..core import field as F
from ..core import fieldv as FV
from ..ops.encrypt import sigma_density
from ..types import Cipher, PubKey, SGN_P, sigma_to_host

_metrics_file = None


def dump_metrics(pk: PubKey, tag: str, C: Cipher, val: int,
                 path: str = "pvac_metrics.csv") -> None:
    """Append-mode CSV (metrics.hpp:13-41); the header is written once per
    process, when the file is first opened."""
    global _metrics_file
    if _metrics_file is None:
        _metrics_file = open(path, "a")
        _metrics_file.write("tag,edges,layers,sigma_density,value_lo,value_hi\n")
    lo, hi = F.fp_to_words(val)
    _metrics_file.write(
        f"{tag},{C.n_edges},{C.n_layers},{sigma_density(pk, C):.6f},{lo},{hi}\n")
    _metrics_file.flush()


def sigma_shannon(C: Cipher) -> float:
    """Byte entropy of all σ rows (metrics.hpp:43-68)."""
    if C.n_edges == 0:
        return 0.0
    by = sigma_to_host(C.sigma).astype("<u4").view(np.uint8)
    freq = np.bincount(by.reshape(-1), minlength=256)
    total = freq.sum()
    if total == 0:
        return 0.0
    p = freq[freq > 0] / total
    return float(-(p * np.log2(p)).sum())


def _layer_gsums(pk: PubKey, X: Cipher) -> list[int]:
    """Signed sum of w * g^idx over each layer's edges."""
    terms = FV.mul(FV.from_u32(X.w), pk.powg_limbs()[X.idx.astype(np.int64)])
    terms = FV.to_ints(terms)
    s = [0] * X.n_layers
    for lid, ch, t in zip(X.layer_id.tolist(), X.ch.tolist(), terms):
        s[lid] = F.fp_add(s[lid], t) if ch == SGN_P else F.fp_sub(s[lid], t)
    return s


def agg_layer_gsum(pk: PubKey, X: Cipher, lid: int) -> int:
    """Signed sum of w * g^idx over one layer's edges (metrics.hpp:70-86)."""
    return _layer_gsums(pk, X)[lid] if lid < X.n_layers else 0


def check_mul_gsum_all(pk: PubKey, A: Cipher, B: Cipher, C: Cipher) -> bool:
    """The homomorphism invariant of ct_mul's layer sums (metrics.hpp:88-113):
    layer base + la*LB + lb of C sums to (layer la of A) * (layer lb of B)."""
    ga, gb, gc = _layer_gsums(pk, A), _layer_gsums(pk, B), _layer_gsums(pk, C)
    base = A.n_layers + B.n_layers
    for la in range(A.n_layers):
        for lb in range(B.n_layers):
            lc = base + la * B.n_layers + lb
            cc = gc[lc] if lc < C.n_layers else 0
            if cc != F.fp_mul(ga[la], gb[lb]):
                return False
    return True
