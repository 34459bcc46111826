"""Job 1 on a read set inside ``search_pairs`` (``ScalLoPS.signatures``
and ``feature_counts``): the program's own device span, from its CUDA
events (``QueryEngine.pair_stats``), mean a job of the window (ms).

Also the shared part of the ``pairdump.*`` readers of the program's job
log. They read the window's jobs: ~10 s of them, where the profiled
stretch after it holds ~1 s under the profiler. While the driver's
``trace_on`` wraps the pipeline's stages, each wrapper's sync lies inside
the device spans of the window, so they read what the wrappers read."""
import numpy as np


def window_jobs(ctx):
    """The program's log entries of the jobs inside the window, or None:
    without a card's trace, without the program's pair-dump log, or where
    the log holds fewer of the window's jobs than the window finished."""
    engine = getattr(ctx.driver, "engine", None)
    log = getattr(engine, "pair_stats", None)
    if ctx.device is None or log is None or not ctx.records:
        return None
    lo, hi = ctx.records[0].t0, ctx.records[-1].t1
    jobs = [j for j in log() if lo <= j["t0"] and j["t1"] <= hi]
    done = sum(r.out is not None for r in ctx.records)
    return jobs if jobs and len(jobs) >= done else None


def job_mean(ctx, key: str, scale: float = 1.0):
    """Mean over the window's jobs of the log's ``key`` (summed where it
    holds one reading an attempt), times ``scale``; None where there are
    no such jobs or a job lacks the reading."""
    vals = [j.get(key) for j in window_jobs(ctx) or ()]
    if not vals or any(v is None for v in vals):
        return None
    return float(np.mean([sum(v) if isinstance(v, tuple) else v
                          for v in vals])) * scale


def read(ctx):
    return job_mean(ctx, "job1_dev_s", 1e3)
