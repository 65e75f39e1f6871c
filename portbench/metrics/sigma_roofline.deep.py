"""The σ kernels' roofline share in the depth chain, counted as
sigma_roofline counts it (roofline/sigma.json: kernel C's work a σ edge,
over the device time of the kernels named sigma_slices_kernel and
sigma_noise_kernel)."""
from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "sigma")
