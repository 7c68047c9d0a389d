"""Device-idle ms a train step spends on its input: the spans
``mimo.data.gather`` (``DeviceDataset.gather``: the index's copy and the
rows' ``index_select``) and ``mimo.train.input`` (``train_step``'s input
transform and normalisation)."""

from benchmark.span_readers import idle_ms

SPANS = ("mimo.data.gather", "mimo.train.input")


def read(ctx):
    return idle_ms(ctx, SPANS, "steps")
