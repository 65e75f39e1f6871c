"""Repeated squaring across the client/evaluator split, the reference's
depth test: each request is one chain, ``Client.encrypt`` of one u64 value
``v``, ``steps`` squarings ``Evaluator.mul_batch([(c, c)])``, each on the
last product, then ``Client.decrypt`` of the last, drained.  A unit is one
squaring.

The check compares every chain's own decryption with v^(2^steps) mod p,
and for the first chain and every ``record_every``-th after it (the loop's
own count of the chains the check keeps) decrypts the final ciphertext
with the plain reference too and measures the share of set bits of its
first σ rows."""
from __future__ import annotations

from .. import cipher
from ..reference import scheme
from . import RequestFailed


class Loop:
    def __init__(self, dep, mix: dict, seed: int):
        self.client = dep.client
        self.evaluator = dep.evaluator
        self.sync = dep.sync
        self.steps = mix["steps"]
        self.every = mix["check"]["record_every"]
        self.rows = mix["check"]["sigma_rows"]
        self.chains = 0  # chains kept by the check so far (the warm request keeps none)

    def run(self, req: dict, span):
        (v,) = req["values"]
        with span("encrypt", 1):
            cts = self.client.encrypt([v])
        if len(cts) != 1:
            raise RequestFailed(f"1 value gave {len(cts)} ciphertexts")
        c = cts[0]
        for _ in range(self.steps):
            with span("mul_batch", 1):
                prods = self.evaluator.mul_batch([(c, c)])
            if len(prods) != 1:
                raise RequestFailed(f"1 pair gave {len(prods)} products")
            c = prods[0]
        with span("decrypt", 1):
            out = self.client.decrypt([c])
        with span("drain", 0):
            self.sync()
        if len(out) != 1:
            raise RequestFailed(f"1 ciphertext gave {len(out)} plaintexts")
        if not req["sample"]:
            return self.steps, []
        rec = sig = None
        if self.chains % self.every == 0:
            rec, sig = cipher.record(c), cipher.sigma_rows(c, self.rows)
        self.chains += 1
        return self.steps, [(v, self.steps, out[0], rec, sig)]


def judge(kept: list, key, device, params: dict) -> dict:
    want = [pow(v, 1 << steps, scheme.P) for v, steps, *_ in kept]
    sampled = [(w, rec, sig) for w, (*_, rec, sig) in zip(want, kept) if rec is not None]
    got = scheme.decrypt_all(key, [rec for _, rec, _ in sampled], device)
    return {"checked": len(sampled), "chains": len(kept),
            "mismatched": (sum(out != w for w, (_, _, out, _, _) in zip(want, kept))
                           + sum(g != w for g, (w, _, _) in zip(got, sampled))),
            "sigma_density_dev": cipher.density_dev([s for *_, s in sampled],
                                                    params["m_bits"])}
