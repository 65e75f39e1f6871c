"""Microseconds a ciphertext of Client.encrypt in its stage enc.plan (shares,
layer plans, PRF seed and domain arrays): the program's counter ns.enc.plan
in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.enc.plan")
    return ns / 1e3 if ns is not None else None
