"""All the join attempts of ``search_pairs`` on a read set
(``ScalLoPS.search``): the program's own device spans of the attempts,
from its CUDA events (``QueryEngine.pair_stats``), summed a job, mean a
job of the window (ms)."""
from pathlib import Path

from bench.harness import load_module


def read(ctx):
    log = load_module("metrics", "pairdump.job1_dev_ms",
                      Path(__file__).resolve().parents[1])
    return log.job_mean(ctx, "join_dev_s", 1e3)
