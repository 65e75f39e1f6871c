"""What the check keeps of a ciphertext: host copies in the reference's
record format, so the ciphertext itself can be released."""
from __future__ import annotations

import numpy as np


def record(ct) -> dict:
    return {"layers": [(L.rule, (L.seed.ztag, L.seed.nonce.lo, L.seed.nonce.hi), L.pa, L.pb)
                       for L in ct.layers],
            "layer_id": np.array(ct.layer_id), "idx": np.array(ct.idx),
            "ch": np.array(ct.ch), "w": np.array(ct.w)}


def sigma_rows(ct, limit: int | None = None) -> np.ndarray:
    """The first ``limit`` σ rows (all with None) as host uint32 words."""
    sig = ct.sigma if limit is None else ct.sigma[:limit]
    return np.array(np.asarray(sig), dtype=np.uint32)


def density_dev(rows: list[np.ndarray], m_bits: int) -> float | None:
    """The widest distance of a σ row's share of set bits from 1/2.  A fresh
    row, the XOR of x_col_wt H columns and err_wt noise bits, is close to a
    row of fair coins (0.0055 a standard deviation at default Params, about
    0.0011 off 1/2 on average); a row left zero reads 0.5."""
    rows = [r for r in rows if r.shape[0]]
    if not rows:
        return None
    ones = np.unpackbits(np.concatenate(rows).view(np.uint8), axis=1).sum(axis=1)
    return float(np.abs(ones / m_bits - 0.5).max())
