"""Microseconds a ciphertext of Client.encrypt in its stage enc.dispatch (the
PRF and sigma launches: word arrays, copies to the card, kernels queued):
the program's counter ns.enc.dispatch in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.enc.dispatch")
    return ns / 1e3 if ns is not None else None
