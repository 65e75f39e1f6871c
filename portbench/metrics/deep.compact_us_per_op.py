"""Microseconds a squaring in the product's budget check and layer
compaction (guard_budget, compact_layers), inside mul.assemble: the
program's counter ns.mul.assemble.compact in engine.stats."""
from portbench.readers import counter_per_unit


def read(ctx):
    ns = counter_per_unit(ctx, "ns.mul.assemble.compact")
    return ns / 1e3 if ns is not None else None
