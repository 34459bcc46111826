"""Supervised worker threads: catch, report, back off, restart, give up
visibly (the port's copy of ``repro/faults/supervisor.py``).

The serving tier's background loops (``AsyncEngine`` dispatch,
``ReplicaFleet`` ingest) run under a :class:`Supervisor` instead of a
bare ``threading.Thread``:

* ``run_once`` is ONE iteration of the worker (drain one batch / apply
  one ingest item), returning the number of items it processed;
* an exception is a **crash**: ``on_crash(exc)`` runs first (the owner
  resolves every outstanding future or event with a typed error —
  nothing may strand), the crash is counted in the obs registry, and the
  loop restarts after an exponential backoff with deterministic seeded
  jitter (a chaos run replays identically);
* a successful iteration that did work resets the consecutive-failure
  count; ``max_consecutive_failures`` crashes in a row means the fault is
  not transient — the supervisor **gives up**: ``on_giveup(exc)`` fires,
  ``degraded`` latches True, and the owner surfaces it in ``stats()``.
"""
from __future__ import annotations

import random
import threading

from ..obs import REGISTRY, instant

_M_RESTARTS = REGISTRY.counter(
    "worker_restarts", "supervised worker crashes that led to a restart",
    labelnames=("worker",))
_M_BACKOFF = REGISTRY.histogram(
    "worker_restart_backoff_seconds", "restart backoff delays",
    labelnames=("worker",))
_M_DEGRADED = REGISTRY.counter(
    "worker_degraded", "supervised workers that exhausted their restart "
    "budget and gave up", labelnames=("worker",))


class Supervisor:
    """Run ``run_once`` in a loop on a daemon thread, surviving crashes.

    ``sleep`` is injectable (tests pass a no-op); backoff jitter comes
    from ``random.Random(seed)`` so a replayed fault script produces the
    same delays. ``stats()`` is the owner's window into crash counts,
    the last error, and the degraded latch.
    """

    def __init__(self, name: str, run_once, *, on_crash=None, on_giveup=None,
                 max_consecutive_failures: int = 5,
                 backoff_base_s: float = 0.01, backoff_cap_s: float = 1.0,
                 seed: int = 0, sleep=None, idle_sleep_s: float = 0.0):
        self.name = name
        self._run_once = run_once
        self._on_crash = on_crash
        self._on_giveup = on_giveup
        self.max_consecutive_failures = int(max_consecutive_failures)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self.idle_sleep_s = float(idle_sleep_s)
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.crashes = 0
        self.consecutive = 0
        self.degraded = False
        self.last_error: str | None = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Supervisor":
        self._thread = threading.Thread(target=self._loop,
                                        name=f"supervised-{self.name}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> bool:
        """Signal the loop to exit and join; returns False when the
        thread failed to join in time (wedged — the caller must report
        it, not swallow it)."""
        self._closed.set()
        if self._thread is None:
            return True
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------------------ the loop
    def backoff_s(self, consecutive: int) -> float:
        """Backoff before restart number ``consecutive`` (1-based):
        ``min(cap, base * 2**(n-1))`` scaled by jitter in [0.5, 1.5)."""
        raw = min(self.backoff_cap_s,
                  self.backoff_base_s * (2.0 ** (consecutive - 1)))
        return raw * (0.5 + self._rng.random())

    def _wait(self, seconds: float) -> None:
        if self._sleep is not None:
            self._sleep(seconds)
        else:
            self._closed.wait(seconds)      # interruptible: stop() wakes it

    def _loop(self) -> None:
        while not self._closed.is_set():
            try:
                did = self._run_once()
            except Exception as e:          # noqa: BLE001 — the whole point
                with self._lock:
                    self.crashes += 1
                    self.consecutive += 1
                    self.last_error = f"{type(e).__name__}: {e}"
                    consec = self.consecutive
                instant("worker_crash", cat="fault", worker=self.name,
                        error=type(e).__name__, consecutive=consec)
                if self._on_crash is not None:
                    try:
                        self._on_crash(e)
                    except Exception:       # noqa: BLE001 — crash handler
                        pass                # must never kill the supervisor
                if consec >= self.max_consecutive_failures:
                    with self._lock:
                        self.degraded = True
                    _M_DEGRADED.inc(worker=self.name)
                    if self._on_giveup is not None:
                        try:
                            self._on_giveup(e)
                        except Exception:   # noqa: BLE001
                            pass
                    return                  # visible death, not a spin
                _M_RESTARTS.inc(worker=self.name)
                delay = self.backoff_s(consec)
                _M_BACKOFF.observe(delay, worker=self.name)
                self._wait(delay)
                continue
            if did:
                with self._lock:
                    self.consecutive = 0
            elif self.idle_sleep_s:
                self._wait(self.idle_sleep_s)

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            return dict(worker=self.name, alive=self.alive,
                        crashes=self.crashes,
                        consecutive_failures=self.consecutive,
                        degraded=self.degraded,
                        last_error=self.last_error)
