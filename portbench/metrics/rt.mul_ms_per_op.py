"""Milliseconds of Evaluator.mul_batch per product (harness span; σ may still run)."""
from portbench.readers import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "mul_batch")
