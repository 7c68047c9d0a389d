"""Host ms of a request: each ``bench.request`` span's wall time less the
device time inside it, as a mean over the window's requests."""

SPAN = "bench.request"


def read(ctx):
    spans = ctx.trace.spans(SPAN)
    if not spans or not ctx.trace.in_window:
        return None
    host = [(e - s) - ctx.trace.busy_within(s, e) for s, e in spans]
    return 1e-6 * sum(host) / len(host)
