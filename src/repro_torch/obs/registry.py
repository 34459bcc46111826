"""Mergeable metrics: fixed-log-bucket histograms, counters, gauges.

The port's copy of ``repro/obs/registry.py``. A histogram with *fixed*
log-spaced bucket bounds keeps O(buckets) memory forever, merges across
replicas bucket by bucket (exactly: merging is associative and
commutative), and recovers any quantile to within one bucket's relative
width (``2**(1/4) - 1`` ≈ 19% worst case at the default resolution).

:class:`Registry` is the process-wide collection point; it renders one
Prometheus text exposition (``search_serve --metrics-out``) or a JSON
snapshot. Instruments are declared at registration: a family knows its
label names, and bumping a label set is the only way to create a child.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = [
    "Histogram", "Counter", "Gauge", "Registry", "REGISTRY",
    "default_bounds",
]


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

    def __len__(self) -> int:
        return self.count

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into ``self`` (in place; returns self). Bounds
        must match exactly — mergeability is why they are fixed."""
        if other.bounds != self.bounds:
            raise ValueError("histogram bounds differ; only histograms "
                             "with identical fixed bounds merge exactly")
        with other._lock:
            oc, osum, ocnt = other.counts.copy(), other.sum, other.count
        with self._lock:
            self.counts += oc
            self.sum += osum
            self.count += ocnt
        return self

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

    def snapshot(self) -> dict:
        """JSON-able: exact count/sum, interpolated p50/p95/p99."""
        return dict(count=self.count, sum=self.sum, mean=self.mean,
                    p50=self.quantile(0.50), p95=self.quantile(0.95),
                    p99=self.quantile(0.99))

    def state(self) -> dict:
        """Full mergeable state (bounds + bucket counts) — what crosses a
        process boundary; rebuild with :meth:`from_state` and merge."""
        with self._lock:
            return dict(bounds=list(self.bounds),
                        counts=self.counts.tolist(),
                        sum=self.sum, count=self.count)

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        h = cls(tuple(state["bounds"]))
        h.counts[:] = np.asarray(state["counts"], np.int64)
        h.sum = float(state["sum"])
        h.count = int(state["count"])
        return h


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


class Gauge:
    """Last-write-wins gauge (one child of a gauge family)."""
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    @property
    def value(self) -> float:
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

    def children(self) -> dict[tuple, object]:
        with self._lock:
            return dict(self._children)


class CounterFamily(_Family):
    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames, Counter)

    def inc(self, by: int = 1, **labels) -> None:
        self.labels(**labels).inc(by)


class GaugeFamily(_Family):
    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames, Gauge)

    def set(self, value: float, **labels) -> None:
        self.labels(**labels).set(value)


class HistogramFamily(_Family):
    def __init__(self, name, help="", labelnames=(), bounds=None):
        self.bounds = tuple(bounds) if bounds is not None else _DEFAULT_BOUNDS
        super().__init__(name, help, labelnames,
                         lambda: Histogram(self.bounds))

    def observe(self, value: float, **labels) -> None:
        self.labels(**labels).observe(value)

    def merged(self) -> Histogram:
        """One histogram folding every child — the fleet-wide view (merge
        is exact)."""
        out = Histogram(self.bounds)
        for child in self.children().values():
            out.merge(child)
        return out


class Registry:
    """Named instrument collection + Prometheus/JSON rendering.
    ``counter``/``gauge``/``histogram`` are get-or-create; a later call
    must agree on type and label names (and bounds) or raise."""

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

    def gauge(self, name, help="", labelnames=()) -> GaugeFamily:
        return self._get_or_create(GaugeFamily, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  bounds=None) -> HistogramFamily:
        fam = self._get_or_create(HistogramFamily, name, help, labelnames,
                                  bounds=bounds)
        if bounds is not None and fam.bounds != tuple(bounds):
            raise ValueError(f"metric {name!r} bounds differ from the "
                             f"registered family's")
        return fam

    def families(self) -> dict:
        with self._lock:
            return dict(self._families)

    # ------------------------------------------------------------ render
    @staticmethod
    def _label_str(labelnames, key) -> str:
        if not labelnames:
            return ""
        inner = ",".join(f'{n}="{v}"' for n, v in zip(labelnames, key))
        return "{" + inner + "}"

    def prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4): histograms render
        cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count`` — the
        reference's text for the same observations."""
        lines = []
        for name, fam in sorted(self.families().items()):
            kind = ("counter" if isinstance(fam, CounterFamily) else
                    "gauge" if isinstance(fam, GaugeFamily) else "histogram")
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {kind}")
            for key, child in sorted(fam.children().items()):
                lab = self._label_str(fam.labelnames, key)
                if isinstance(child, Histogram):
                    cum = 0
                    with child._lock:
                        counts = child.counts.copy()
                        total, s = child.count, child.sum
                    for le, c in zip(fam.bounds, counts[:-1]):
                        cum += int(c)
                        blab = self._label_str(
                            fam.labelnames + ("le",), key + (f"{le:.6g}",))
                        lines.append(f"{name}_bucket{blab} {cum}")
                    blab = self._label_str(fam.labelnames + ("le",),
                                           key + ("+Inf",))
                    lines.append(f"{name}_bucket{blab} {total}")
                    lines.append(f"{name}_sum{lab} {s}")
                    lines.append(f"{name}_count{lab} {total}")
                else:
                    lines.append(f"{name}{lab} {child.value}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able nested snapshot: {name: {labels_repr: value|hist}}."""
        out = {}
        for name, fam in self.families().items():
            entry = {}
            for key, child in fam.children().items():
                k = ",".join(f"{n}={v}" for n, v in
                             zip(fam.labelnames, key)) or ""
                entry[k] = (child.snapshot() if isinstance(child, Histogram)
                            else child.value)
            out[name] = entry
        return out


#: The process-wide registry every layer registers into.
REGISTRY = Registry()
