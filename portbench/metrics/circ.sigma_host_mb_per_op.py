"""Megabytes of σ rows brought from the card to the host per product, where
a sum's σ concatenation or compact_edges materialises rows held on the
card: the program's counter sigma.host_bytes in engine.stats, which
compact_edges keeps even where it reads none (0 then)."""


def read(ctx):
    b = ctx.counters.get("sigma.host_bytes")
    return b / ctx.units / 1e6 if b is not None and ctx.units else None
