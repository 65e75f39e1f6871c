"""Microseconds a squaring in its stage mul.cross (the native aggregator
and its staging): the program's counter ns.mul.cross in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.mul.cross")
    return ns / 1e3 if ns is not None else None
