"""K6's count in every attempt of the dense join (``core/hamming.py``
``threshold_pairs``, from the ``hamming_counts`` call to the exclusive
cumsum): the program's own device spans from its CUDA events
(``QueryEngine.pair_stats``' ``count_dev_s``), summed a job, mean a job of
the window (ms). None for a flip- or band-joined index."""
from pathlib import Path

from bench.harness import load_module


def read(ctx):
    log = load_module("metrics", "pairdump.job1_dev_ms",
                      Path(__file__).resolve().parents[1])
    return log.job_mean(ctx, "count_dev_s", 1e3)
