"""Share of the traced serving window in which no operation ran on the card."""

from benchmark.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
