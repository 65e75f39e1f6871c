"""Encrypted analytics across the client/evaluator split: each request takes
``2 n`` distinct ciphertexts from a pool of fresh ones that the client
encrypted in set-up, ``xs`` the first ``n`` and ``ys`` the rest, and the
evaluator computes ``dot_product(xs, ys)``, ``matvec(xs, rows)`` over
``rows`` public rows of u16 weights (drawn from the loop's own stream of
the seed) and ``mean_and_scaled_variance(ys[:samples])``; then
``Client.decrypt`` of all ``1 + rows + 2`` results, drained.  A unit is
one product: ``n + samples + 1`` a request.

The check compares every request's decrypted results with the plaintext
circuits mod p, and for the first request and every ``record_every``-th
after it (the loop's own count of the requests the check keeps) decrypts
the dot product, the first matvec row and the variance pair with the plain
reference too and measures the share of set bits of the dot product's
first σ rows."""
from __future__ import annotations

from .. import cipher, generator
from ..reference import scheme
from . import RequestFailed

# the loop's own stream of a seed, after the generator's streams
WEIGHTS = 5


class Loop:
    def __init__(self, dep, mix: dict, seed: int):
        self.client = dep.client
        self.evaluator = dep.evaluator
        self.sync = dep.sync
        self.rows = mix["rows"]
        self.samples = mix["samples"]
        self.every = mix["check"]["record_every"]
        self.sigma_rows = mix["check"]["sigma_rows"]
        self.weights = generator.rng(seed, WEIGHTS)
        self.values = generator.pool_values(mix, seed)
        self.pool = dep.client.encrypt(self.values)
        dep.sync()
        self.requests = 0  # requests kept by the check so far (the warm request keeps none)

    def run(self, req: dict, span):
        n, picks = req["n"], req["picks"]
        xs = [self.pool[i] for i in picks[:n]]
        ys = [self.pool[i] for i in picks[n:]]
        rows = self.weights.integers(0, 1 << 16, (self.rows, n)).tolist()
        ev = self.evaluator
        with span("dot_product", n):
            dot = ev.dot_product(xs, ys)
        with span("matvec", 0):
            mv = ev.matvec(xs, rows)
        with span("variance", self.samples + 1):
            S, V = ev.mean_and_scaled_variance(ys[:self.samples])
        results = [dot, *mv, S, V]
        with span("decrypt", len(results)):
            out = self.client.decrypt(results)
        with span("drain", 0):
            self.sync()
        if len(mv) != self.rows or len(out) != len(results):
            raise RequestFailed(f"{self.rows} rows gave {len(mv)} results, "
                                f"{len(results)} ciphertexts {len(out)} plaintexts")
        units = n + self.samples + 1
        if not req["sample"]:
            return units, []
        recs = sig = None
        if self.requests % self.every == 0:
            recs = [cipher.record(c) for c in (dot, mv[0], S, V)]
            sig = cipher.sigma_rows(dot, self.sigma_rows)
        self.requests += 1
        v = self.values
        return units, [([v[i] for i in picks[:n]], [v[i] for i in picks[n:]], rows,
                        self.samples, out, recs, sig)]


def plain(x: list[int], y: list[int], rows: list[list[int]], samples: int) -> list[int]:
    """The request's circuits on its plaintexts mod p, in the order of the
    results: the dot product, each matvec row, S and V."""
    P = scheme.P
    ys = y[:samples]
    s = sum(ys)
    return ([sum(a * b for a, b in zip(x, y)) % P]
            + [sum(k * a for k, a in zip(r, x)) % P for r in rows]
            + [s % P, (samples * sum(a * a for a in ys) - s * s) % P])


def judge(kept: list, key, device, params: dict) -> dict:
    want, sampled = [], []
    for x, y, rows, samples, out, recs, sig in kept:
        w = plain(x, y, rows, samples)
        want.append(w)
        if recs is not None:
            sampled.append(([w[0], w[1], w[-2], w[-1]], recs, sig))
    got = scheme.decrypt_all(key, [r for _, recs, _ in sampled for r in recs], device)
    ref_want = [v for w, _, _ in sampled for v in w]
    return {"checked": len(sampled), "requests": len(kept),
            "mismatched": (sum(g != v for w, k in zip(want, kept) for g, v in zip(k[4], w))
                           + sum(g != v for g, v in zip(got, ref_want))),
            "sigma_density_dev": cipher.density_dev([s for *_, s in sampled],
                                                    params["m_bits"])}
