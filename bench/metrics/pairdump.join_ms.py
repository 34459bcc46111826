"""All the join attempts of ``search_pairs`` on a read set
(``ScalLoPS.search``), host clock up to a device sync, mean a job (ms)."""
from bench.readers import info_mean


def read(ctx):
    return info_mean(ctx, "join_s", 1e3)
