"""σ edges the engines generated (engine.stats) per squaring: the product's
eager σ, and the fresh ciphertext's, amortised over the chain's squarings."""
from portbench.readers import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "sigma_edges")
