"""Microseconds a squaring in Client.decrypt of the chain's last product,
one decryption over the chain's squarings: the program's counter ns.dec
(the whole of dec_value_batch) in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.dec")
    return ns / 1e3 if ns is not None else None
