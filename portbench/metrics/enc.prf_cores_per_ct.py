"""PRF cores the engines ran (engine.stats) per ciphertext encrypted."""
from portbench.readers import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "prf_cores")
