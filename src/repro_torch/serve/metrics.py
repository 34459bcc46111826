"""Serving-tier observability adapters: rolling percentiles + counters
(the port's copy of ``repro/serve/metrics.py``).

:class:`Rolling` keeps exact sample-window percentiles ("what is latency
*now*") and can mirror every sample into a registry
:class:`~repro_torch.obs.registry.Histogram` child, whose fixed-log-bucket
counts merge exactly across replicas. :class:`Counters` is a named-counter
bag whose names are **declared at construction**; bumping an undeclared
name warns (a typo'd name would otherwise split a count in two) but still
counts.
"""
from __future__ import annotations

import threading
import warnings
from collections import deque

import numpy as np


class Rolling:
    """Rolling latency window: ``add(seconds)``, read p50/p95/p99 over the
    most recent ``window`` samples. Thread-safe — the dispatch thread adds
    while callers snapshot. ``hist`` (optional) is a
    :class:`repro_torch.obs.registry.Histogram` that receives every sample too:
    the window answers "what is latency *now*", the histogram merges
    across replicas and never forgets."""

    def __init__(self, window: int = 4096, hist=None):
        self._buf: deque = deque(maxlen=int(window))
        self._n = 0                     # total ever added (not windowed)
        self._lock = threading.Lock()
        self._hist = hist

    def add(self, seconds: float) -> None:
        with self._lock:
            self._buf.append(float(seconds))
            self._n += 1
        if self._hist is not None:
            self._hist.observe(seconds)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    @property
    def total(self) -> int:
        """Samples ever added (the window only bounds what percentiles
        are computed over)."""
        with self._lock:
            return self._n

    def snapshot(self) -> dict:
        """{count, total, p50_ms, p95_ms, p99_ms, mean_ms} over the
        current window (zeros when empty)."""
        with self._lock:
            arr = np.asarray(self._buf, dtype=np.float64)
            n = self._n
        if arr.size == 0:
            return dict(count=0, total=n, p50_ms=0.0, p95_ms=0.0,
                        p99_ms=0.0, mean_ms=0.0)
        return dict(
            count=int(arr.size),
            total=n,
            p50_ms=float(np.percentile(arr, 50) * 1e3),
            p95_ms=float(np.percentile(arr, 95) * 1e3),
            p99_ms=float(np.percentile(arr, 99) * 1e3),
            mean_ms=float(arr.mean() * 1e3),
        )


class Counters:
    """Thread-safe named counters (shed reasons, ingests, compactions).

    Names are declared at construction. An undeclared ``bump`` warns —
    the registry's declared-at-registration discipline, adapted: the old
    behaviour silently created a fresh key, so a typo'd name split the
    count in two and both halves looked plausible. The bump still counts
    (back-compat), but the typo is now loud."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._c = {n: 0 for n in names}
        self._declared = frozenset(names)

    def bump(self, name: str, by: int = 1) -> None:
        if name not in self._declared:
            warnings.warn(
                f"Counters.bump({name!r}): undeclared counter name "
                f"(declared: {sorted(self._declared)}) — counting anyway, "
                f"but check for a typo", stacklevel=2)
        with self._lock:
            self._c[name] = self._c.get(name, 0) + by

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._c.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)
