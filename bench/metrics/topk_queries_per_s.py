"""Queries answered over the whole window (queries/s)."""
from bench.readers import rate


def read(ctx):
    return rate(ctx)
