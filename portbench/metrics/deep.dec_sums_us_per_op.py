"""Microseconds a squaring in decryption's edge windows, the host limb
math over every edge of the chain's last product: the program's counter
ns.dec.sums in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.dec.sums")
    return ns / 1e3 if ns is not None else None
