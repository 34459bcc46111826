"""Cross-process metric aggregation: worker registries fold into the parent.

The port's copy of ``repro/obs/aggregate.py``. The registry's instruments
merge by design (fixed-bound histogram bucket counts add exactly; counters
add; gauges are last-write-wins); this module carries a whole registry
across a process boundary. A worker serializes its
:data:`~repro_torch.obs.registry.REGISTRY` with :func:`registry_state` (a
JSON-able dict built on ``Histogram.state()``), ships it over whatever
transport the caller has, and the parent folds it in with
:func:`merge_registry_state`, declaring missing families on the fly, so N
workers' histograms aggregate into the exact fleet histogram.

The JSON is the reference's, key for key: a snapshot either package
writes merges into the other's registry.

Used by the all-pairs CLI (``launch/allpairs.py --metrics-merge``).
"""
from __future__ import annotations

from .registry import (REGISTRY, CounterFamily, GaugeFamily, Histogram,
                       HistogramFamily, Registry)

__all__ = ["registry_state", "merge_registry_state"]

_KINDS = {"counter": CounterFamily, "gauge": GaugeFamily,
          "histogram": HistogramFamily}


def _kind_of(fam) -> str:
    if isinstance(fam, CounterFamily):
        return "counter"
    if isinstance(fam, GaugeFamily):
        return "gauge"
    return "histogram"


def registry_state(registry: Registry | None = None) -> dict:
    """Serialize a registry's full mergeable state (JSON-able). Every
    family carries its identity (kind, help, label names, histogram
    bounds) so the receiving side can declare it before merging."""
    registry = REGISTRY if registry is None else registry
    out = {}
    for name, fam in registry.families().items():
        kind = _kind_of(fam)
        children = []
        for key, child in fam.children().items():
            if isinstance(child, Histogram):
                children.append([list(key), child.state()])
            else:
                children.append([list(key), child.value])
        entry = dict(kind=kind, help=fam.help,
                     labelnames=list(fam.labelnames), children=children)
        if kind == "histogram":
            entry["bounds"] = list(fam.bounds)
        out[name] = entry
    return {"families": out}


def merge_registry_state(state: dict,
                         registry: Registry | None = None) -> Registry:
    """Fold a worker's :func:`registry_state` snapshot into ``registry``
    (default: the process-wide :data:`REGISTRY`); returns the registry.

    Histogram bucket counts add (``Histogram.merge`` enforces identical
    bounds), counters add, gauges take the incoming value. Families the
    parent never declared are declared with the worker's identity;
    families both sides declared must agree on kind and label names, or
    the registry's redeclaration check raises.
    """
    registry = REGISTRY if registry is None else registry
    for name, entry in state.get("families", {}).items():
        kind = entry["kind"]
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r} for {name!r}")
        labelnames = tuple(entry.get("labelnames", ()))
        help_ = entry.get("help", "")
        if kind == "counter":
            fam = registry.counter(name, help_, labelnames)
        elif kind == "gauge":
            fam = registry.gauge(name, help_, labelnames)
        else:
            fam = registry.histogram(name, help_, labelnames,
                                     bounds=tuple(entry["bounds"]))
        for key, payload in entry.get("children", []):
            child = fam.labels(**dict(zip(labelnames, key)))
            if kind == "counter":
                child.inc(int(payload))
            elif kind == "gauge":
                child.set(float(payload))
            else:
                child.merge(Histogram.from_state(payload))
    return registry
