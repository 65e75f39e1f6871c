"""Edge pairs of the cross products per squaring: the program's counter
mul.pairs in engine.stats (|A| x |B| a product of Evaluator.mul_batch)."""
from portbench.readers import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "mul.pairs")
