"""repro_torch.faults — deterministic fault injection and the one atomic
write path every persisted artifact goes through.

* ``plan``   — :class:`FaultPlan`: a seedable fault script. Faults fire at
  named **sites** (``store.write``, ...) on scripted call numbers:
  raise-on-Nth-call, latency spikes, thread kills, torn writes; every
  firing lands in a ledger and in the registry's ``faults_injected``.
* ``atomic`` — :func:`atomic_write`: tmp file + fsync + ``os.replace``
  (+ directory fsync), so a crash anywhere leaves the destination either
  old or new. The torn-write fault kind bypasses it on purpose, to make
  the damage that ``SignatureIndex.load(..., recover=True)`` survives.
* ``supervisor`` — :class:`Supervisor`: the worker-thread harness the
  serving tier runs its dispatch and ingest loops under: crashes are
  caught and reported, the loop restarts under seeded exponential
  backoff, and a bounded run of consecutive failures gives up into a
  visible ``degraded`` state.

The port of ``repro/faults``.
"""
from .atomic import atomic_write
from .plan import (FaultPlan, FaultSpec, InjectedFault, ThreadKilled,
                   active_plan, fault_point)
from .supervisor import Supervisor

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault", "ThreadKilled",
    "active_plan", "fault_point",
    "Supervisor",
    "atomic_write",
]
