"""Helpers that the metric readers in ``bench/metrics`` share. A reader
returns None where it finds nothing to read; the harness then leaves the
metric out of the result line."""
from __future__ import annotations

import numpy as np


def rate(ctx):
    """Units (queries, reads) of every finished call over the window."""
    done = sum(r.spec.n for r in ctx.records if r.out is not None)
    return done / ctx.window_s if ctx.window_s > 0 and done else None


def latency_ms(ctx, q: float):
    """The q-th percentile of every call's time in the window, ms."""
    ms = [(r.t1 - r.t0) * 1e3 for r in ctx.records]
    return float(np.percentile(ms, q)) if ms else None


def span_ms(ctx, name: str):
    """Mean duration of the program's spans named ``name``, ms."""
    d = [s["dur"] for s in ctx.spans if s["name"] == name and s["dur"]]
    return float(np.mean(d)) * 1e3 if d else None


def info_mean(ctx, key: str, scale: float = 1.0):
    """Mean over the window's calls of a per-call reading of the driver."""
    v = [r.info[key] for r in ctx.records if key in r.info]
    return float(np.mean(v)) * scale if v else None


def idle_pct(ctx):
    """The share of the profiled stretch with no kernel or copy running."""
    dev = ctx.device
    if dev is None or dev.window_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)


def kernel_s(ctx, match) -> float:
    """Device seconds of the profiled stretch's kernels whose name
    ``match`` accepts."""
    if ctx.device is None:
        return 0.0
    return sum(b - a for name, a, b in ctx.device.ops if match(name)) / 1e6
