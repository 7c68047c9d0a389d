"""The train conv kernels' share of their roofline: the bounds of every
K5 / K6 / K7 site of the window's steps over those kernels' device time."""

from benchmark import yardstick
from benchmark.readers import roofline_pct

KERNELS = ("conv_fwd_tc", "conv_dx_tc", "conv_dw_tc")


def read(ctx):
    tr = ctx.traffic
    sites = yardstick.train_conv_sites(ctx.config, tr["batch"], tr["height"], tr["width"])
    return roofline_pct(ctx, KERNELS, sites, ctx.counts["steps"])
