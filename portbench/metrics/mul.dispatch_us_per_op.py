"""Microseconds a product of Evaluator.mul_batch in its stage mul.dispatch
(sigma seed words, salts, pooling and launches): the program's counter
ns.mul.dispatch in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.mul.dispatch")
    return ns / 1e3 if ns is not None else None
