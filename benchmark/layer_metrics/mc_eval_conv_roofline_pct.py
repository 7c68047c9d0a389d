"""The fused eval DoubleConv's share of its roofline on the MC route: the
bounds of every K1 / K2 site of the window's requests, each forward's batch
the request's frames times the MC passes (``yardstick_mc``), over that
kernel's device time."""

from benchmark import yardstick_mc
from benchmark.readers import roofline_pct

KERNELS = ("fused_double_conv_tc",)


def read(ctx):
    tr = ctx.traffic
    sites = yardstick_mc.mc_eval_conv_sites(ctx.config, tr["request_frames"],
                                            tr["monte_carlo_steps"], tr["height"], tr["width"])
    return roofline_pct(ctx, KERNELS, sites, ctx.counts.get("requests", 0))
