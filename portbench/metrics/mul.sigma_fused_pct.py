"""σ edges that took the fused launch of kernels B and C (engine.stats
sigma_fused_edges) as a share of all σ edges the engines generated, in
percent.  None where the program has no such counter."""


def read(ctx):
    fused, edges = ctx.counters.get("sigma_fused_edges"), ctx.counters.get("sigma_edges")
    return 100.0 * fused / edges if fused is not None and edges else None
