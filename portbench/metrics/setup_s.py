"""Seconds from the start of the run to the window: imports, CUDA context,
the kernel library (built on a checkout's first run), keys, pool, warm request."""


def read(ctx):
    return ctx.setup_seconds
