"""The traffic generator: one general reader of ``traffic/<mix>.json``.

A mix names its loop and the sizes of its requests.  Sizes are drawn
log-uniform between ``min`` and ``max`` as ``levels`` fixed quantiles of
that distribution, each block of ``levels`` requests holding every level
once in an order drawn from the seed.  So every seed offers the same work
per block, in another order, and runs with different seeds differ only
as much as two runs of one seed.

Plaintexts are u64 values drawn from the seed; the check's sample of each
request is drawn from a stream of its own, so it never shifts the
requests.
"""
from __future__ import annotations

import numpy as np

U64 = (1 << 64) - 1
# stream ids under one seed
REQUESTS, VALUES, SAMPLE, POOL, WARM = range(5)


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one stream of a run; any whole-number seed works."""
    return np.random.default_rng(np.random.SeedSequence([seed & U64, stream]))


def levels(size: dict) -> list[int]:
    lo, hi, k = size["min"], size["max"], size["levels"]
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / k))) for i in range(k)]


def u64_values(g: np.random.Generator, n: int) -> list[int]:
    return [int(v) for v in g.integers(0, 1 << 64, n, dtype=np.uint64)]


def requests(mix: dict, seed: int):
    """An endless sequence of requests: dicts with ``n`` (the size),
    ``values`` (u64 plaintexts, ``n * mix["values_per_unit"]`` of them),
    ``picks`` (distinct pool indices, ``2 n``, for a loop on a pool) and
    ``sample`` (the indices of the units the check keeps)."""
    g_order, g_val, g_smp = rng(seed, REQUESTS), rng(seed, VALUES), rng(seed, SAMPLE)
    lv = levels(mix["size"])
    per_unit = mix.get("values_per_unit", 1)
    pool = mix.get("pool", 0)
    keep = mix["check"]["per_request"]
    while True:
        for n in (lv[i] for i in g_order.permutation(len(lv))):
            req = {"n": n}
            if pool:
                req["picks"] = [int(i) for i in g_val.choice(pool, 2 * n, replace=False)]
            else:
                req["values"] = u64_values(g_val, n * per_unit)
            req["sample"] = (list(range(n)) if keep is None or keep >= n
                             else sorted(int(i) for i in g_smp.choice(n, keep, replace=False)))
            yield req


def warm_request(mix: dict, seed: int) -> dict:
    """One request at the mix's largest size, with values of its own."""
    g = rng(seed, WARM)
    n = max(levels(mix["size"]))
    req = {"n": n, "sample": []}
    if mix.get("pool", 0):
        req["picks"] = [int(i) for i in g.choice(mix["pool"], 2 * n, replace=False)]
    else:
        req["values"] = u64_values(g, n * mix.get("values_per_unit", 1))
    return req


def pool_values(mix: dict, seed: int) -> list[int]:
    return u64_values(rng(seed, POOL), mix.get("pool", 0))
