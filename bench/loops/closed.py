"""Closed loop, one client: the plan's calls in turn, each sent when the
one before has returned, until the window has passed (the last call runs
to its end). A call's time runs from its submission to its result."""
from __future__ import annotations

import time
import traceback

from bench.harness import Record


def run(drv, plan, seconds: float, *, start: int = 0, min_calls: int = 1,
        traced: bool = False):
    """Returns (records, failed calls, the plan's next position)."""
    records, failed = [], 0
    i = start
    t_begin = time.perf_counter()
    while True:
        spec = plan[i % len(plan)]
        i += 1
        t0 = time.perf_counter()
        try:
            out = drv.call(spec)
        except Exception:               # a failed call is counted, not fatal
            traceback.print_exc()
            out, failed = None, failed + 1
        t1 = time.perf_counter()
        records.append(Record(spec, out, t0, t1,
                              drv.after_call() if traced else {}))
        if t1 - t_begin >= seconds and len(records) >= min_calls:
            return records, failed, i
