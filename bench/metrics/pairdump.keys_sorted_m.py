"""Flip keys that the joins of ``search_pairs`` sort, mean a job of the
window (M keys): each join attempt of the program's job log
(``QueryEngine.pair_stats``) sorts one key a flip mask (every bit pattern
of weight <= d over f bits) a reference. None for an index that is not
flip-joined."""
from math import comb
from pathlib import Path

from bench.harness import load_module


def read(ctx):
    log = load_module("metrics", "pairdump.job1_dev_ms",
                      Path(__file__).resolve().parents[1])
    attempts = log.job_mean(ctx, "attempts")
    if attempts is None:
        return None
    index = ctx.driver.engine.index
    cfg = index.cfg
    if cfg.join_method != "flip":
        return None
    masks = sum(comb(cfg.f, i) for i in range(cfg.d + 1))
    return attempts * masks * index.size / 1e6
