"""Microseconds a product in the tree sums (models/circuits.sum_chain of
the dot product, each matvec row and the variance): the program's counter
ns.sum in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.sum")
    return ns / 1e3 if ns is not None else None
