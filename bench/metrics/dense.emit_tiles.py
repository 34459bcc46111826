"""Emission tiles of the dense join over all of a job's attempts, the
program's counter (``QueryEngine.pair_stats``' ``emit_tiles``), mean a job
of the window (count). None for a flip- or band-joined index."""
from pathlib import Path

from bench.harness import load_module


def read(ctx):
    log = load_module("metrics", "pairdump.job1_dev_ms",
                      Path(__file__).resolve().parents[1])
    return log.job_mean(ctx, "emit_tiles")
