"""Share of the edges into compact_edges that a bucket merged away:
100 x (1 - compact.buckets / compact.edges), the program's counters in
engine.stats.  Near 0 says the compaction was a pure reorder."""


def read(ctx):
    edges = ctx.counters.get("compact.edges")
    if not edges:
        return None
    return 100.0 * (1.0 - ctx.counters.get("compact.buckets", 0) / edges)
