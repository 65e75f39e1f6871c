"""Microseconds a product in compact_edges, wherever a request runs it (the
dot product's root sum, S * S in Evaluator.mul_batch, V's ct_sub): the
program's counter ns.compact_edges in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.compact_edges")
    return ns / 1e3 if ns is not None else None
