"""Join attempts a job: the calls of ``ScalLoPS.search`` that the
grow-and-retry loop of ``search_pairs`` makes (count)."""
from bench.readers import info_mean


def read(ctx):
    return info_mean(ctx, "attempts")
