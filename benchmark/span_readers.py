"""What the per-layer readers of the port's own spans share.

The port opens ``record_function`` spans (``mimo_unet_torch/train/
profiling.py`` ``SPANS``) while a profiler collects; they are host events on
the profiler's clock, so the traced window's device intervals
(``trace.Trace``) read against them with no conversion.  A program without
those spans leaves these readers nothing to read: they return ``None``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from benchmark.readers import ReadContext


def window_spans(ctx: ReadContext, names: Sequence[str]) -> List[Tuple[int, int]]:
    """The union of the spans named ``names``, clipped to the window (ns)."""
    w0, w1 = ctx.trace.window
    clipped = sorted((max(s, w0), min(e, w1)) for n in names for s, e in ctx.trace.spans(n)
                     if e > w0 and s < w1)
    merged: List[List[int]] = []
    for s, e in clipped:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_ms(ctx: ReadContext, names: Sequence[str], units_key: str) -> Optional[float]:
    """Device-idle ms inside the spans named ``names`` (each span's wall time
    less the device's busy time inside it, within the window), per unit of
    ``ctx.counts[units_key]``; ``None`` where the window holds none of them."""
    units = ctx.counts.get(units_key, 0)
    spans = window_spans(ctx, names)
    if not spans or units <= 0:
        return None
    idle = sum((e - s) - ctx.trace.busy_within(s, e) for s, e in spans)
    return 1e-6 * idle / units
