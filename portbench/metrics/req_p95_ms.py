"""95th percentile of request latency, every request of the window, from its issue."""
from portbench.readers import percentile_ms


def read(ctx):
    return percentile_ms(ctx, 95)
