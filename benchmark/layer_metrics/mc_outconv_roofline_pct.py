"""K11's share of its roofline on the MC route: the bound of the grouped 1x1
out-conv of the window's requests (``yardstick_mc.mc_outconv_sites``) over
the device time of ``conv1x1_kernel``, which on a serving route runs only
as K11."""

from benchmark import yardstick_mc
from benchmark.readers import roofline_pct

KERNELS = ("conv1x1_kernel",)


def read(ctx):
    tr = ctx.traffic
    sites = yardstick_mc.mc_outconv_sites(ctx.config, tr["request_frames"],
                                          tr["monte_carlo_steps"], tr["height"], tr["width"])
    return roofline_pct(ctx, KERNELS, sites, ctx.counts.get("requests", 0))
