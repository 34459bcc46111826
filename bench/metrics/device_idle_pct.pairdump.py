"""Share of the profiled stretch with no kernel or copy running on the
card (%)."""
from bench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
