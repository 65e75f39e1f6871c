"""Request loops, one module per traffic ``loop`` name.  A loop's ``Loop``
runs one request and returns its units and what the check keeps;
``judge`` compares what was kept with the plain reference."""


class RequestFailed(Exception):
    """A request whose answer is not whole (a missing ciphertext, product
    or plaintext)."""
