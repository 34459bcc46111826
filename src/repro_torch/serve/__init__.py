"""repro_torch.serve — the asynchronous serving tier over the index (the
port of ``repro/serve``).

* ``engine``  — :class:`AsyncEngine`: futures-based ``submit()``, a
  supervised background dispatch thread draining a bounded queue into the
  padding-ladder micro-batcher (bit-exact with the synchronous
  ``flush()`` path), max-wait/max-batch dispatch, and deadline-aware
  admission control with typed :class:`Completed` / :class:`Rejected` /
  :class:`Degraded` outcomes.
* ``fleet``   — :class:`ReplicaFleet`: N ``ShardedIndex`` replicas behind
  a least-outstanding router with quarantine, half-open probes and one
  retry, and a supervised ingest loop (``add()`` → rolling per-replica
  delta ``refresh()`` → periodic minor compaction) that never takes a
  replica out of rotation unserved; every answer carries its epoch.
* ``metrics`` — rolling p50/p95/p99 windows and declared counters,
  mirrored into the mergeable histograms of :mod:`repro_torch.obs`.

``submit()`` mints a per-query trace ID that rides a contextvar through
dispatch → router → replica → ring → re-rank (:mod:`repro_torch.obs`).
"""
from .engine import AsyncEngine, Completed, Degraded, Rejected
from .fleet import DegradedBatch, IngestTicket, ReplicaFleet
from .metrics import Counters, Rolling

__all__ = [
    "AsyncEngine", "Completed", "Degraded", "Rejected",
    "DegradedBatch", "IngestTicket", "ReplicaFleet",
    "Counters", "Rolling",
]
