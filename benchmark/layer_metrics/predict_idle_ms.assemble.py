"""Device-idle ms a request spends in ``Ensemble.predict``'s assemble
stage, the span ``mimo.predict.assemble``: the chunks' answers
concatenated on the host."""

from benchmark.span_readers import idle_ms

SPANS = ("mimo.predict.assemble",)


def read(ctx):
    return idle_ms(ctx, SPANS, "requests")
