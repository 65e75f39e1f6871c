"""Microseconds a ciphertext that the caller waited on the card after
Client.encrypt returned: the harness's span ``encrypt`` less the program's
counter ns.enc (the whole of enc_value_batch), per ciphertext."""
from portbench.readers import counter_per_unit, span_ms_per_unit


def read(ctx):
    harness = span_ms_per_unit(ctx, "encrypt")
    program = counter_per_unit(ctx, "ns.enc")
    if harness is None or program is None:
        return None
    return harness * 1e3 - program / 1e3
