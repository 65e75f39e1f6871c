"""Kernel C (kernels/sigma.cu, both launches): its roofline bound for the
window's σ edges over its device time (roofline/sigma.json)."""
from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "sigma")
