"""Microseconds a product of Evaluator.mul_batch in its stage mul.layers (the
PROD layer grid of each product): the program's counter ns.mul.layers in
engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.mul.layers")
    return ns / 1e3 if ns is not None else None
