"""Microseconds a ciphertext of Client.encrypt in its stage enc.weights (edge
weights from the PRF cores): the program's counter ns.enc.weights in
engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.enc.weights")
    return ns / 1e3 if ns is not None else None
