"""Microseconds a product that the caller waited on the card after
Evaluator.mul_batch returned: the harness's span ``mul_batch`` less the
program's counter ns.mul (the whole of ct_mul_batch), per product."""
from portbench.readers import counter_per_unit, span_ms_per_unit


def read(ctx):
    harness = span_ms_per_unit(ctx, "mul_batch")
    program = counter_per_unit(ctx, "ns.mul")
    if harness is None or program is None:
        return None
    return harness * 1e3 - program / 1e3
