"""Device-idle ms a train step spends in ``train_step``'s backward stage,
the span ``mimo.train.backward``: ``loss.backward()``."""

from benchmark.span_readers import idle_ms

SPANS = ("mimo.train.backward",)


def read(ctx):
    return idle_ms(ctx, SPANS, "steps")
