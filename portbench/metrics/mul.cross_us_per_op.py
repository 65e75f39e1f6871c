"""Microseconds a product of Evaluator.mul_batch in its stage mul.cross (the
host cross product and bucket sums, or the card's grid dispatch and fetch):
the program's counter ns.mul.cross in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.mul.cross")
    return ns / 1e3 if ns is not None else None
