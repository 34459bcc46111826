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

The port of ``repro/faults``; its worker-thread ``Supervisor`` comes
with the serving tier.
"""
from .atomic import atomic_write
from .plan import (FaultPlan, FaultSpec, InjectedFault, ThreadKilled,
                   active_plan, fault_point)

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault", "ThreadKilled",
    "active_plan", "fault_point",
    "atomic_write",
]
