"""Deterministic, seedable fault-injection registry (the port's copy of
``repro/faults/plan.py``; its counter lives in the port's registry).

A :class:`FaultPlan` is a script: *at the Nth call to site S, do X*.
Sites are string names compiled into the serving/persistence layers
(:func:`fault_point` calls); call numbers are per-site, 1-based, counted
only while the plan is installed. Because the serving tier funnels every
query batch through one dispatch thread, call numbering at a site is a
deterministic function of the caller's submission order — which is what
lets the chaos benchmark assert its retry/quarantine/shed counters
against the script exactly, not approximately.

Fault kinds:

``raise``    raise :class:`InjectedFault` (an ordinary ``Exception`` —
             the handling under test must treat it like any backend
             error).
``kill``     raise :class:`ThreadKilled` — semantically "this worker
             thread died"; the supervisor restarts the loop, and any
             per-call handling that resolved outstanding work first has
             done its job.
``latency``  sleep ``delay_s`` then continue (a slow replica / GC pause
             / straggler — admission control and deadline shedding see
             it, nothing fails).
``torn``     returned to the call site instead of raised — only
             :func:`repro_torch.faults.atomic.atomic_write` consumes it, by
             writing ``frac`` of the payload straight to the destination
             and then crashing (the non-atomic writer this repo no
             longer is, manufactured on demand for recovery tests).

Install with ``with plan: ...`` (or ``plan.install()`` /
``plan.uninstall()``). The active plan is a module-level global, not a
contextvar, deliberately: faults must fire on *background threads*
(dispatch, ingest) that were started long before the plan existed.
"""
from __future__ import annotations

import threading
import time

from ..obs import REGISTRY

#: every injected fault, labeled by site and kind — the registry-side
#: mirror of the plan's ledger (merges across processes like any counter)
_M_INJECTED = REGISTRY.counter(
    "faults_injected", "deterministically injected faults",
    labelnames=("site", "kind"))

_KINDS = ("raise", "kill", "latency", "torn")


class InjectedFault(RuntimeError):
    """A deterministically injected failure (never raised in production:
    only a :class:`FaultPlan` constructs it)."""

    def __init__(self, site: str, call: int, kind: str = "raise"):
        super().__init__(f"injected {kind} fault at {site!r} (call #{call})")
        self.site = site
        self.call = call
        self.kind = kind


class ThreadKilled(InjectedFault):
    """An injected worker-thread death (``kind="kill"``)."""

    def __init__(self, site: str, call: int):
        super().__init__(site, call, kind="kill")


class FaultSpec:
    """One scripted fault: fire ``kind`` at site ``site`` on the call
    numbers in ``on`` (1-based, counted per site while the plan is
    installed)."""

    __slots__ = ("site", "kind", "on", "delay_s", "frac")

    def __init__(self, site: str, kind: str = "raise", *,
                 on=1, delay_s: float = 0.05, frac: float = 0.5):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {_KINDS})")
        self.site = site
        self.kind = kind
        self.on = frozenset(int(n) for n in
                            ((on,) if isinstance(on, int) else on))
        if any(n < 1 for n in self.on):
            raise ValueError("fault call numbers are 1-based")
        self.delay_s = float(delay_s)
        self.frac = float(frac)

    def __repr__(self):
        return (f"FaultSpec({self.site!r}, {self.kind!r}, "
                f"on={sorted(self.on)})")


class FaultPlan:
    """A deterministic fault script plus its execution ledger.

    Thread-safe: per-site call counters and the ledger are updated under
    one lock, so concurrent serving threads observe a single global call
    order per site (which thread draws the faulted call number may vary;
    *how many* faults fire, and their handling counts, never does).
    """

    def __init__(self, *specs: FaultSpec, sleep=time.sleep):
        self._specs: list[FaultSpec] = list(specs)
        self._calls: dict[str, int] = {}
        self._ledger: list[tuple[str, int, str]] = []   # (site, call, kind)
        self._lock = threading.Lock()
        self._sleep = sleep

    # ------------------------------------------------------------ scripting
    def add(self, site: str, kind: str = "raise", *, on=1,
            delay_s: float = 0.05, frac: float = 0.5) -> "FaultPlan":
        """Append one scripted fault; chainable."""
        self._specs.append(FaultSpec(site, kind, on=on, delay_s=delay_s,
                                     frac=frac))
        return self

    # ------------------------------------------------------------ firing
    def fire(self, site: str, **ctx) -> FaultSpec | None:
        """Count one call to ``site`` and apply any fault scripted for
        this call number. ``raise``/``kill`` raise, ``latency`` sleeps,
        ``torn`` is *returned* for the call site to enact. Returns None
        when nothing fires."""
        with self._lock:
            call = self._calls.get(site, 0) + 1
            self._calls[site] = call
            hit = next((s for s in self._specs
                        if s.site == site and call in s.on), None)
            if hit is not None:
                self._ledger.append((site, call, hit.kind))
        if hit is None:
            return None
        _M_INJECTED.inc(site=site, kind=hit.kind)
        if hit.kind == "latency":
            self._sleep(hit.delay_s)
            return None
        if hit.kind == "kill":
            raise ThreadKilled(site, call)
        if hit.kind == "raise":
            raise InjectedFault(site, call)
        return hit                                      # torn: caller enacts

    # ------------------------------------------------------------ ledger
    def calls(self, site: str) -> int:
        """Calls counted at ``site`` so far (while installed)."""
        with self._lock:
            return self._calls.get(site, 0)

    def fired(self, site: str | None = None, kind: str | None = None) -> int:
        """How many scripted faults actually fired (optionally filtered)."""
        with self._lock:
            return sum(1 for s, _c, k in self._ledger
                       if (site is None or s == site)
                       and (kind is None or k == kind))

    def ledger(self) -> list[tuple[str, int, str]]:
        with self._lock:
            return list(self._ledger)

    def unfired(self) -> list[FaultSpec]:
        """Scripted faults whose call numbers were never reached — a
        chaos run asserting determinism wants this EMPTY."""
        with self._lock:
            fired = {(s, c) for s, c, _k in self._ledger}
            return [spec for spec in self._specs
                    if any((spec.site, n) not in fired
                           and n > self._calls.get(spec.site, 0)
                           for n in spec.on)]

    def summary(self) -> dict:
        """JSON-able script-vs-execution accounting for bench artifacts."""
        with self._lock:
            scripted: dict[str, int] = {}
            for s in self._specs:
                key = f"{s.site}:{s.kind}"
                scripted[key] = scripted.get(key, 0) + len(s.on)
            fired: dict[str, int] = {}
            for site, _c, kind in self._ledger:
                key = f"{site}:{kind}"
                fired[key] = fired.get(key, 0) + 1
            return dict(scripted=scripted, fired=fired,
                        calls=dict(self._calls))

    # ------------------------------------------------------------ install
    def install(self) -> "FaultPlan":
        global _ACTIVE
        with _INSTALL_LOCK:
            if _ACTIVE is not None and _ACTIVE is not self:
                raise RuntimeError("another FaultPlan is already installed")
            _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        with _INSTALL_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


_ACTIVE: FaultPlan | None = None
_INSTALL_LOCK = threading.Lock()


def active_plan() -> FaultPlan | None:
    return _ACTIVE


def fault_point(site: str, **ctx) -> FaultSpec | None:
    """The hook compiled into serving/persistence code. No plan installed
    (production): one global load + branch. Plan installed: count the
    call and apply whatever the script says. Only ``torn``-aware call
    sites (``atomic_write``) use the return value."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.fire(site, **ctx)
