"""Bulk encryption by the key holder: each request is ``Client.encrypt``
of ``n`` u64 values, drained.  A unit is one ciphertext.

The check decrypts the sampled ciphertexts with the plain reference and
measures their σ rows' share of set bits."""
from __future__ import annotations

from .. import cipher
from ..reference import scheme
from . import RequestFailed


class Loop:
    def __init__(self, dep, mix: dict, seed: int):
        self.client = dep.client
        self.sync = dep.sync

    def run(self, req: dict, span):
        values = req["values"]
        with span("encrypt", len(values)):
            cts = self.client.encrypt(values)
            self.sync()
        if len(cts) != len(values):
            raise RequestFailed(f"{len(values)} values gave {len(cts)} ciphertexts")
        return len(cts), [(values[i], cipher.record(cts[i]), cipher.sigma_rows(cts[i]))
                          for i in req["sample"]]


def judge(kept: list, key, device, params: dict) -> dict:
    got = scheme.decrypt_all(key, [rec for _, rec, _ in kept], device)
    return {"checked": len(kept),
            "mismatched": sum(g != v % scheme.P for g, (v, _, _) in zip(got, kept)),
            "sigma_density_dev": cipher.density_dev([s for *_, s in kept], params["m_bits"])}
