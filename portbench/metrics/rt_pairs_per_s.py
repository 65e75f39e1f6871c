"""Pairs taken from plaintext to a decrypted product per second over the window."""
from portbench.readers import rate


def read(ctx):
    return rate(ctx)
