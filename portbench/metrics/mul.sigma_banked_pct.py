"""σ edges whose rows the fused launch of kernels B and C wrote in bank
order (engine.stats sigma_banked_edges) as a share of all σ edges the
engines generated, in percent.  None where the program has no such
counter."""


def read(ctx):
    banked, edges = ctx.counters.get("sigma_banked_edges"), ctx.counters.get("sigma_edges")
    return 100.0 * banked / edges if banked is not None and edges else None
