"""Microseconds a ciphertext of Client.encrypt in its stage enc.wait (reading
the PRF cores back: the host blocked on the card): the program's counter
ns.enc.wait in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.enc.wait")
    return ns / 1e3 if ns is not None else None
