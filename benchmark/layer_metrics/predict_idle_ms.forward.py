"""Device-idle ms a request spends in ``Ensemble.predict``'s forward stage,
the span ``mimo.predict.forward``: the members' forward and the
uncertainty decomposition."""

from benchmark.span_readers import idle_ms

SPANS = ("mimo.predict.forward",)


def read(ctx):
    return idle_ms(ctx, SPANS, "requests")
