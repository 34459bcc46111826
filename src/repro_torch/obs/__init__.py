"""repro_torch.obs — spans, per-query trace IDs and mergeable metrics.

The port's copy of ``repro/obs``:

* ``trace``    — structured spans with per-query trace IDs minted at
  ``AsyncEngine.submit()`` and carried (contextvar) through router,
  replica, ring probe and re-rank; lifecycle events (seal, delta refresh,
  compactions); a bounded thread-safe buffer with Chrome/Perfetto export.
  Disabled tracing costs one branch. Spans sit on the wall clock that
  ``torch.profiler`` uses (``ts`` in seconds since the Unix epoch), and
  ``TRACER.export(path, merge=<the profiler's export_chrome_trace file>)``
  writes both traces as one timeline.
* ``registry`` — fixed-log-bucket histograms that merge exactly across
  replicas, declared counters and gauges, one process-wide
  :data:`REGISTRY`, Prometheus text exposition and a JSON snapshot.
* ``aggregate`` — the cross-process carrier for the registry: workers
  ship :func:`registry_state` snapshots (the reference's JSON) and the
  parent folds them in with :func:`merge_registry_state` (the all-pairs
  CLI's ``--metrics-merge``).
* ``jit``      — the recompile sentinel: every cached builder (a kernel
  library, a table uploaded to a device) records a build per (site,
  key); a key built twice is a silent rebuild, and
  ``SENTINEL.expect_no_compiles()`` turns "zero builds after warmup"
  into an asserted invariant.
"""
from .aggregate import merge_registry_state, registry_state
from .jit import SENTINEL, CompileSentinel, trace_sentinel
from .registry import (REGISTRY, Counter, Gauge, Histogram, Registry,
                       default_bounds)
from .trace import (TRACER, Tracer, current_trace, disable, enable, instant,
                    new_trace_id, record, span, trace_context)

__all__ = [
    "TRACER", "Tracer", "span", "instant", "record", "new_trace_id",
    "trace_context", "current_trace", "enable", "disable",
    "REGISTRY", "Registry", "Histogram", "Counter", "Gauge",
    "default_bounds", "registry_state", "merge_registry_state",
    "SENTINEL", "CompileSentinel", "trace_sentinel",
]
