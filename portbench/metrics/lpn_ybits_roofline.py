"""Kernel A (kernels/lpn_ybits.cu): its roofline bound for the window's PRF
cores over its device time (roofline/lpn_ybits.json)."""
from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "lpn_ybits")
