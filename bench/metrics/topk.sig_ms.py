"""Mean of the program's ``sig`` span of ``QueryEngine.query_batch``, a
batch (ms)."""
from bench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "sig")
