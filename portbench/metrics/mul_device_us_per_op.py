"""Microseconds of the card's time (a kernel or a copy on it, from the
device trace) per product completed in the window."""
from portbench.readers import device_us_per_unit


def read(ctx):
    return device_us_per_unit(ctx)
