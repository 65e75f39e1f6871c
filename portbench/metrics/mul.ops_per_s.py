"""Products completed, σ drained, per second over the traced window: the
caller's rate, which ct_mul's host stages in ``Evaluator.mul_batch`` set."""
from portbench.readers import rate


def read(ctx):
    return rate(ctx)
