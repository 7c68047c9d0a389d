"""The fused eval DoubleConv's share of its roofline: the bounds of every
K1 / K2 site of the window's requests over that kernel's device time."""

from benchmark import yardstick
from benchmark.readers import roofline_pct

KERNELS = ("fused_double_conv_tc",)


def read(ctx):
    tr = ctx.traffic
    sites = yardstick.eval_conv_sites(ctx.config, tr["request_frames"], tr["height"],
                                      tr["width"])
    return roofline_pct(ctx, KERNELS, sites, ctx.counts["requests"])
