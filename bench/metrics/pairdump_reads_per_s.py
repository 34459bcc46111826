"""Reads whose pair dump finished, over the whole window (reads/s)."""
from bench.readers import rate


def read(ctx):
    return rate(ctx)
