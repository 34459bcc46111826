"""Metrics: fixed-log-bucket histograms and counters.

The port's copy of the part of ``repro/obs/registry.py`` that serving
uses. A histogram with *fixed* log-spaced bucket bounds keeps O(buckets)
memory forever, adds up across replicas bucket by bucket, and recovers
any quantile to within one bucket's relative width (``2**(1/4) - 1`` ≈
19% worst case at the default resolution).

Instruments are declared at registration: a family knows its label
names, and bumping a label set is the only way to create a child.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["Histogram", "Counter", "Registry", "REGISTRY", "default_bounds"]


def default_bounds(lo: float = 1e-6, n: int = 112,
                   growth: float = 2 ** 0.25) -> tuple:
    """Fixed log-spaced bucket upper bounds: ``lo * growth**i`` — 1 µs ..
    ~250 s in quarter-doublings. Two histograms merge iff their bounds are
    identical, so the bounds are part of the metric's identity."""
    return tuple(lo * growth ** i for i in range(n))


_DEFAULT_BOUNDS = default_bounds()


class Histogram:
    """Fixed-bucket histogram: ``observe(value)``, exact ``count``/``sum``,
    bucket-interpolated quantiles. Thread-safe; ``counts`` has
    ``len(bounds) + 1`` slots, the last for overflow."""

    __slots__ = ("bounds", "_edges", "counts", "sum", "count", "_lock")

    def __init__(self, bounds: tuple | None = None):
        self.bounds = tuple(bounds) if bounds is not None else _DEFAULT_BOUNDS
        self._edges = np.asarray(self.bounds, np.float64)
        self.counts = np.zeros(len(self.bounds) + 1, np.int64)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = int(np.searchsorted(self._edges, value, side="left"))
        with self._lock:
            self.counts[i] += 1
            self.sum += float(value)
            self.count += 1

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0..1) by geometric interpolation inside
        the bucket holding that rank; 0 when empty, the top bound when the
        rank lands in the overflow bucket."""
        with self._lock:
            counts = self.counts.copy()
            n = self.count
        if n == 0:
            return 0.0
        rank = q * n
        cum = np.cumsum(counts)
        i = int(np.searchsorted(cum, rank, side="left"))
        if i >= len(self.bounds):
            return float(self.bounds[-1])
        hi = self.bounds[i]
        lo = self.bounds[i - 1] if i > 0 else hi / (self.bounds[1] /
                                                    self.bounds[0])
        below = cum[i - 1] if i > 0 else 0
        inside = counts[i]
        frac = 1.0 if inside == 0 else min(1.0, (rank - below) / inside)
        return float(lo * (hi / lo) ** frac)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Counter:
    """Monotonic counter (one child of a counter family)."""
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, by: int = 1) -> None:
        with self._lock:
            self._v += by

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class _Family:
    """A named metric family with declared label names; children are
    created per label-value tuple on first use."""

    def __init__(self, name: str, help: str, labelnames: tuple, make_child):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._make = make_child
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def labels(self, **labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make()
        return child


class HistogramFamily(_Family):
    def __init__(self, name, help="", labelnames=(), bounds=None):
        self.bounds = tuple(bounds) if bounds is not None else _DEFAULT_BOUNDS
        super().__init__(name, help, labelnames,
                         lambda: Histogram(self.bounds))


class CounterFamily(_Family):
    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames, Counter)

    def inc(self, by: int = 1, **labels) -> None:
        self.labels(**labels).inc(by)


class Registry:
    """Named instrument collection. ``counter``/``histogram`` are
    get-or-create; a later call must agree on type and label names."""

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(
                    name, help, tuple(labelnames), **kw)
                return fam
        if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(fam).__name__}{fam.labelnames}; redeclaration with "
                f"{cls.__name__}{tuple(labelnames)} is a bug")
        return fam

    def counter(self, name, help="", labelnames=()) -> CounterFamily:
        return self._get_or_create(CounterFamily, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  bounds=None) -> HistogramFamily:
        return self._get_or_create(HistogramFamily, name, help, labelnames,
                                   bounds=bounds)


#: The process-wide registry every layer registers into.
REGISTRY = Registry()
