"""Microseconds a ciphertext of Client.encrypt in its stage enc.draw (edge
indices, signs and free weights drawn for every layer): the program's
counter ns.enc.draw in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.enc.draw")
    return ns / 1e3 if ns is not None else None
