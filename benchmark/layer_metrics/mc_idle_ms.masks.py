"""Device-idle ms a request spends drawing its dropout masks, the span
``mimo.dropout.draw`` (``DropoutSource.draw``: one ``torch.rand`` a live
site)."""

from benchmark.span_readers import idle_ms

SPANS = ("mimo.dropout.draw",)


def read(ctx):
    return idle_ms(ctx, SPANS, "requests")
