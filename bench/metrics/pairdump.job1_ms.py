"""Job 1 on a read set inside ``search_pairs`` (``ScalLoPS.signatures``
and ``feature_counts``), host clock up to a device sync, mean a job (ms)."""
from bench.readers import info_mean


def read(ctx):
    return info_mean(ctx, "job1_s", 1e3)
