"""An evaluator serving depth-1 products: each request is
``Evaluator.mul_batch`` of ``n`` pairs drawn without repeats from a pool of
fresh ciphertexts that the client encrypted in set-up, drained.  A unit is
one product.

The check decrypts the sampled products with the plain reference against
the product of their plaintexts mod p, and measures the share of set bits
of their first σ rows."""
from __future__ import annotations

from .. import cipher, generator
from ..reference import scheme
from . import RequestFailed


class Loop:
    def __init__(self, dep, mix: dict, seed: int):
        self.evaluator = dep.evaluator
        self.sync = dep.sync
        self.rows = mix["check"]["sigma_rows"]
        self.values = generator.pool_values(mix, seed)
        self.pool = dep.client.encrypt(self.values)
        dep.sync()

    def run(self, req: dict, span):
        n, picks = req["n"], req["picks"]
        pairs = [(self.pool[picks[2 * k]], self.pool[picks[2 * k + 1]]) for k in range(n)]
        with span("mul_batch", n):
            prods = self.evaluator.mul_batch(pairs)
            self.sync()
        if len(prods) != n:
            raise RequestFailed(f"{n} pairs gave {len(prods)} products")
        v = self.values
        return n, [((v[picks[2 * k]], v[picks[2 * k + 1]]), cipher.record(prods[k]),
                    cipher.sigma_rows(prods[k], self.rows)) for k in req["sample"]]


def judge(kept: list, key, device, params: dict) -> dict:
    got = scheme.decrypt_all(key, [rec for _, rec, _ in kept], device)
    return {"checked": len(kept),
            "mismatched": sum(g != a * b % scheme.P for g, ((a, b), _, _) in zip(got, kept)),
            "sigma_density_dev": cipher.density_dev([s for *_, s in kept], params["m_bits"])}
