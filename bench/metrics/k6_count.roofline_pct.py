"""K6 (``kernels/csrc/hamming.cu`` ``count_kernel``, the dense join's count)
against its roofline: the least time the profiled jobs' counts need
(``bench/roofline_hamming.py``: every attempt counts all read x reference
pairs) over K6's device time there (%).

Also the shared part of the dense join's roofline readers: the profiled
stretch's jobs in the program's job log (``QueryEngine.pair_stats``)."""
import re

from bench import roofline_hamming
from bench.readers import kernel_s

K6 = re.compile(r"(?<![A-Za-z0-9_])count(_wide)?_kernel(?![A-Za-z0-9_])")


def profiled_jobs(ctx):
    """(reads, log entry) of each finished job of the profiled stretch, or
    None without a job log or where it lacks one of them."""
    engine = getattr(ctx.driver, "engine", None)
    log = getattr(engine, "pair_stats", None)
    if log is None or not ctx.profiled:
        return None
    jobs, out = log(), []
    for r in ctx.profiled:
        if r.out is None:
            continue
        mine = [j for j in jobs if r.t0 <= j["t0"] and j["t1"] <= r.t1]
        if len(mine) != 1:
            return None
        out.append((r.spec.n, mine[0]))
    return out or None


def shapes(ctx):
    """(references, words a signature) of the index the jobs join."""
    index = ctx.driver.engine.index
    return index.size, index.cfg.f // 32


def read(ctx):
    k6 = kernel_s(ctx, lambda name: K6.search(name) is not None)
    jobs = profiled_jobs(ctx)
    clock = roofline_hamming.sm_clock_hz() if k6 > 0 and jobs else None
    if clock is None:
        return None
    R, nw = shapes(ctx)
    bound = sum(j["attempts"]
                * roofline_hamming.hamming_count_bound_s(n, R, nw, clock)[0]
                for n, j in jobs)
    return 100.0 * bound / k6
