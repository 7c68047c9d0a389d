"""Device ms a request spends outside the port's kernels and copies: the
plain modules (the cuDNN core and the glue)."""

from benchmark.readers import plain_ms


def read(ctx):
    return plain_ms(ctx, "requests")
