"""What the per-layer readers (``benchmark/layer_metrics/*.py``) share.

A reader gets a ``ReadContext``: the traced window (``trace.Trace``), the
driver's counts of the window's work, the cell's configuration and
traffic.  It returns the metric in its unit, or ``None`` where the trace
holds nothing to read (the harness then leaves the metric out); a share of
a roofline or a peak is never reported as 0 for want of a reading.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence

from benchmark import yardstick
from benchmark.trace import Trace

# every kernel of mimo_unet_torch/csrc (its __global__ functions), by name
PORT_KERNELS = (
    "conv_fwd_tc", "conv_dx_tc", "conv_dw_tc", "fused_double_conv_tc",
    "pool2x2_kernel", "pool2x2_bwd_kernel", "pool_w_kernel", "pool_w_pairs_kernel",
    "chunk_kernel", "conv1x1_kernel", "affine_bwd_kernel", "reduce_groups_kernel",
    "up2_fwd_kernel", "up2_bwd_kernel", "lerp_h2x_t_kernel", "upsample_w2x_kernel",
    "upsample_w2x_bwd_kernel",
)
# torch.optim.Adam (foreach) runs every update through multi_tensor_apply
OPTIMIZER_KERNELS = ("multi_tensor_apply_kernel",)


@dataclasses.dataclass
class ReadContext:
    trace: Trace
    counts: Dict[str, int]
    config: dict
    traffic: dict


def name_matcher(names: Sequence[str]) -> Callable[[str], bool]:
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    return lambda n: pat.search(n) is not None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def idle_pct(ctx: ReadContext) -> Optional[float]:
    t = ctx.trace
    if not t.in_window or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(ctx: ReadContext, kind: str, units_key: str) -> Optional[float]:
    """Model FLOPs of the window's images (frames) over its time, against
    the bf16 peak."""
    t, tr = ctx.trace, ctx.traffic
    if not t.in_window or t.window_s <= 0:
        return None
    flops = yardstick.model_flops(ctx.config, kind, tr["height"], tr["width"])
    return 100.0 * flops * ctx.counts[units_key] / t.window_s / yardstick.PEAKS["bf16_flops"]


def roofline_pct(ctx: ReadContext, kernels: Sequence[str], sites: List[dict],
                 units: int) -> Optional[float]:
    """Sum of the sites' bounds over the units of work in the window,
    divided by the device time of the kernels that serve them."""
    seconds = ctx.trace.device_seconds(name_matcher(kernels))
    if seconds <= 0 or units <= 0:
        return None
    return 100.0 * yardstick.bound_seconds(sites) * units / seconds


def plain_ms(ctx: ReadContext, units_key: str) -> Optional[float]:
    """Device time of every operation that is neither a port kernel, nor
    the optimizer's, nor a copy, per unit of work."""
    units = ctx.counts.get(units_key, 0)
    if not ctx.trace.in_window or units <= 0:
        return None
    port = name_matcher(PORT_KERNELS + OPTIMIZER_KERNELS)
    return 1e3 * ctx.trace.device_seconds(lambda n: not port(n) and not is_copy(n)) / units
