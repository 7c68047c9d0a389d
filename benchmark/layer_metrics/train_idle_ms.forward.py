"""Device-idle ms a train step spends in ``train_step``'s forward stage, the
span ``mimo.train.forward``: ``zero_grad`` and the objective (the forward
and the loss)."""

from benchmark.span_readers import idle_ms

SPANS = ("mimo.train.forward",)


def read(ctx):
    return idle_ms(ctx, SPANS, "steps")
