"""Scheme parameters (reference: include/pvac/core/types.hpp:36-70).

Defaults match the reference exactly.  Params round-trip through the
``params.json`` format written by the bounty tooling
(tests/bounty2_test.cpp:238-252), which serializes a 10-field subset.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class Params:
    # Multiplicative subgroup order; must divide p - 1 = 2^127 - 2.
    B: int = 337

    # Syndrome / hypergraph dimensions.
    m_bits: int = 8192
    n_bits: int = 16384
    h_col_wt: int = 192
    x_col_wt: int = 128
    err_wt: int = 128

    # Noise-plan knobs.
    noise_entropy_bits: float = 120.0
    tuple2_fraction: float = 0.55
    depth_slope_bits: float = 16.0
    edge_budget: int = 1200000

    # LPN instance (tau = lpn_tau_num / lpn_tau_den).
    lpn_n: int = 4096
    lpn_t: int = 16384
    lpn_tau_num: int = 1
    lpn_tau_den: int = 8

    # Recrypt density band.
    recrypt_lo: float = 0.48
    recrypt_hi: float = 0.52
    recrypt_rounds: int = 8

    @property
    def sigma_words32(self) -> int:
        """uint32 words per syndrome bit-vector."""
        return (self.m_bits + 31) // 32

    @property
    def s_words64(self) -> int:
        """uint64 words in an LPN sample row / the LPN secret."""
        return (self.lpn_n + 63) // 64


def small_test_params() -> Params:
    """Reduced-size parameters used by fast tests and the small golden set.

    Must stay in sync with tools/refharness/gen_golden.cpp.
    """
    return Params(
        m_bits=512,
        n_bits=1024,
        h_col_wt=48,
        x_col_wt=32,
        err_wt=32,
        lpn_n=256,
        lpn_t=1024,
    )


# The 10 fields the bounty params.json format stores, in its key order
# (tests/bounty2_test.cpp:238-252).
_JSON_FIELDS = (
    "m_bits",
    "B",
    "lpn_t",
    "lpn_n",
    "lpn_tau_num",
    "lpn_tau_den",
    "noise_entropy_bits",
    "depth_slope_bits",
    "tuple2_fraction",
    "edge_budget",
)


def params_to_json(p: Params) -> str:
    """Serialize in the reference's params.json layout."""
    lines = ["{"]
    for i, k in enumerate(_JSON_FIELDS):
        v = getattr(p, k)
        if isinstance(v, float) and v == int(v):
            v = int(v)
        comma = "," if i < len(_JSON_FIELDS) - 1 else ""
        lines.append(f'  "{k}": {json.dumps(v)}{comma}')
    lines.append("}")
    return "\n".join(lines) + "\n"


def params_from_json(text: str) -> Params:
    d = json.loads(text)
    p = Params()
    for k, v in d.items():
        if hasattr(p, k):
            setattr(p, k, type(getattr(p, k))(v))
    return p
