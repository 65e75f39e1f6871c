"""Ciphertexts encrypted and drained per second over the traced window: the
caller's rate, which the host's staging in ``Client.encrypt`` sets."""
from portbench.readers import rate


def read(ctx):
    return rate(ctx)
