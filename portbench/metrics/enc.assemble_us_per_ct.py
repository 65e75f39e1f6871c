"""Microseconds a ciphertext of Client.encrypt in its stage enc.assemble (sigma
views, shuffle keys, Cipher assembly and the edge budget): the program's
counter ns.enc.assemble in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.enc.assemble")
    return ns / 1e3 if ns is not None else None
