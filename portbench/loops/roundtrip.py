"""The client/evaluator round trip: the client encrypts ``2 n`` values, the
evaluator multiplies the ``n`` pairs, the client decrypts the products;
drained.  A unit is one pair taken from plaintext to a decrypted product.

The check compares every decrypted product with the product of its
plaintexts mod p."""
from __future__ import annotations

from ..reference import scheme
from . import RequestFailed


class Loop:
    def __init__(self, dep, mix: dict, seed: int):
        self.client = dep.client
        self.evaluator = dep.evaluator
        self.sync = dep.sync

    def run(self, req: dict, span):
        n, values = req["n"], req["values"]
        with span("encrypt", 2 * n):
            cts = self.client.encrypt(values)
        with span("mul_batch", n):
            prods = self.evaluator.mul_batch(list(zip(cts[0::2], cts[1::2])))
        with span("decrypt", n):
            out = self.client.decrypt(prods)
        with span("drain", 0):
            self.sync()
        if len(out) != n:
            raise RequestFailed(f"{n} pairs gave {len(out)} plaintexts")
        return n, [(values[2 * k], values[2 * k + 1], out[k]) for k in req["sample"]]


def judge(kept: list, key, device, params: dict) -> dict:
    return {"checked": len(kept),
            "mismatched": sum(got != a * b % scheme.P for a, b, got in kept)}
