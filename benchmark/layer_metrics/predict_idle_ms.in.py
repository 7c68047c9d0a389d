"""Device-idle ms a request spends in ``Ensemble.predict``'s input stage,
the span ``mimo.predict.in``: the frames made a tensor, padded and copied
to the card."""

from benchmark.span_readers import idle_ms

SPANS = ("mimo.predict.in",)


def read(ctx):
    return idle_ms(ctx, SPANS, "requests")
