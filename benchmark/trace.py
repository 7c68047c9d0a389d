"""The traced run's events, read once from ``torch.profiler`` in memory.

``Trace.from_profiler`` keeps, in the profiler's own clock (ns):
* ``device``: every operation that ran on the card (kernels, copies,
  memsets), as (start, end, name); the profiler's own GPU-side
  annotations are left out, they are spans, not work;
* ``host``: every host-side op, runtime call and annotation, as (start,
  end, name);
* ``window``: the span of the ``bench.window`` annotation the harness
  puts around the measured window.

Busy time is the union of device intervals, so copies on a side stream
that overlap a kernel count once.  Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import heapq
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Tuple

WINDOW = "bench.window"

Interval = Tuple[int, int, str]


def _ns(ev, what: str) -> int:
    """An event's start or duration in ns, whichever the torch build gives."""
    ns = getattr(ev, f"{what}_ns", None)
    return ns() if ns is not None else int(round(getattr(ev, f"{what}_us")() * 1000))


def _merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    def __init__(self, device: List[Interval], host: List[Interval]):
        self.device = sorted(device)
        self.host = sorted(host)
        spans = self.spans(WINDOW)
        if spans:
            self.window = (spans[0][0], spans[-1][1])
        else:
            lo = min([d[0] for d in self.device] + [h[0] for h in self.host] or [0])
            hi = max([d[1] for d in self.device] + [h[1] for h in self.host] or [0])
            self.window = (lo, hi)
        w0, w1 = self.window
        self.in_window = [(max(s, w0), min(e, w1), n) for s, e, n in self.device
                          if e > w0 and s < w1]
        self.busy = _merge((s, e) for s, e, _ in self.in_window)
        self._busy_starts = [s for s, _ in self.busy]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        device, host = [], []
        for ev in prof.profiler.kineto_results.events():
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            if str(ev.device_type()).endswith("CUDA"):
                device.append((start, end, ev.name()))
            else:
                host.append((start, end, ev.name()))
        # the GPU-side copies of host annotations (record_function spans,
        # the optimizer's step) carry the host span's name: spans, not work
        spans = {n for _, _, n in host}
        return cls([d for d in device if d[2] not in spans], host)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def spans(self, name: str) -> List[Tuple[int, int]]:
        return [(s, e) for s, e, n in self.host if n == name]

    def busy_within(self, a: int, b: int) -> int:
        """Union of device time inside [a, b], ns."""
        i = max(bisect.bisect_right(self._busy_starts, a) - 1, 0)
        total = 0
        for s, e in self.busy[i:]:
            if s >= b:
                break
            total += max(0, min(e, b) - max(s, a))
        return total

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        """Summed duration of the window's device operations whose name matches."""
        return sum(e - s for s, e, n in self.in_window if match(n)) * 1e-9

    def top_device_ops(self, k: int = 10) -> List[list]:
        by = defaultdict(int)
        for s, e, n in self.in_window:
            by[n] += e - s
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The window's idle device time, summed by the innermost host op
        running at each gap's midpoint, longest first."""
        w0, w1 = self.window
        gaps, at = [], w0
        for s, e in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if w1 > at:
            gaps.append((at, w1))
        by: Dict[str, int] = defaultdict(int)
        heap: List[Tuple[int, int, str]] = []
        i, host = 0, self.host
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) // 2
            while i < len(host) and host[i][0] <= mid:
                heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            name = heap[0][2] if heap else "(no host op)"
            by[name] += b - a
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

