"""The whole train step's share of the bf16 peak: model FLOPs (forward and
backward) of the window's images over the window's time."""

from benchmark.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "train", "images")
