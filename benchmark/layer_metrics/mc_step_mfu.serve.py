"""MC-dropout ``predict``'s share of the bf16 peak: model FLOPs of one
served forward of a frame (``yardstick.model_flops``; the dropout scales
are elementwise and not counted) times the MC passes the window served
(``passes``, from the program's ``mc_counts()``), over the window's time."""

from benchmark import yardstick


def read(ctx):
    t, tr = ctx.trace, ctx.traffic
    passes = ctx.counts.get("passes", 0)
    if not t.in_window or t.window_s <= 0 or passes <= 0:
        return None
    flops = yardstick.model_flops(ctx.config, "serve", tr["height"], tr["width"])
    return 100.0 * flops * passes / t.window_s / yardstick.PEAKS["bf16_flops"]
