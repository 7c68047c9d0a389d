"""The whole of ``predict``'s share of the bf16 peak: model FLOPs of the
window's frames (one forward each) over the window's time."""

from benchmark.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "serve", "frames")
