"""Share of the traced window with no kernel or copy on the card."""
from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
