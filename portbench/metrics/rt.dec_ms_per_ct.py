"""Milliseconds of Client.decrypt per product decrypted (harness span)."""
from portbench.readers import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "decrypt")
