"""Bytes that ``search_pairs`` takes from host arrays onto the card
(``ScalLoPS._chunks`` and ``_on_device``), the program's counter, mean a
job of the window (MB = 1e6 B)."""
from pathlib import Path

from bench.harness import load_module


def read(ctx):
    log = load_module("metrics", "pairdump.job1_dev_ms",
                      Path(__file__).resolve().parents[1])
    return log.job_mean(ctx, "h2d_bytes", 1e-6)
