"""Device-idle ms a request spends in ``Ensemble.predict``'s fetch stage,
the span ``mimo.predict.fetch``: the three answers copied to the host as
numpy."""

from benchmark.span_readers import idle_ms

SPANS = ("mimo.predict.fetch",)


def read(ctx):
    return idle_ms(ctx, SPANS, "requests")
