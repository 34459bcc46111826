"""95th percentile of every batch's time in the window, from
submission to its numpy result (ms)."""
from bench.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 95)
