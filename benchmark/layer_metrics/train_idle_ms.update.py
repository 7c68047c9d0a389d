"""Device-idle ms a train step spends in ``train_step``'s update stage, the
span ``mimo.train.update``: the zero-gradient fill, the gradient sync, Adam
and the schedule, the loss buffer, the logs and metrics."""

from benchmark.span_readers import idle_ms

SPANS = ("mimo.train.update",)


def read(ctx):
    return idle_ms(ctx, SPANS, "steps")
