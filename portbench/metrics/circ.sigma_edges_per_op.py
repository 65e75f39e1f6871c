"""σ edges the engines generated (engine.stats) per product: the request's
products' eager σ (fresh ciphertexts come from the pool, encrypted in
set-up)."""
from portbench.readers import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "sigma_edges")
