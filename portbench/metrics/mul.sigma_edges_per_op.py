"""σ edges the engines generated (engine.stats) per product."""
from portbench.readers import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "sigma_edges")
