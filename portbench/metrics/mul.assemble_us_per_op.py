"""Microseconds a product of Evaluator.mul_batch in its stage mul.assemble
(sigma views, Cipher assembly, the edge budget and layer compaction): the
program's counter ns.mul.assemble in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.mul.assemble")
    return ns / 1e3 if ns is not None else None
