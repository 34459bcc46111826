"""Structured tracing: spans into a bounded ring buffer.

The port's copy of the part of ``repro/obs/trace.py`` that serving uses.
Disabled tracing is one branch: :func:`span` checks a flag and returns a
shared no-op context manager, :func:`record` returns at once. Tracing is
off by default.
"""
from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["TRACER", "Tracer", "span", "record", "enable", "disable"]


class Tracer:
    """Bounded thread-safe span buffer."""

    def __init__(self, capacity: int = 65536):
        self.enabled = False
        self._buf: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def record(self, name: str, cat: str, t0: float, t1: float,
               attrs: dict | None = None) -> None:
        """Append one span (t0/t1 are ``perf_counter`` seconds)."""
        ev = (name, cat, t0 - self._t0, t1 - t0,
              threading.current_thread().name, dict(attrs or {}))
        with self._lock:
            self._buf.append(ev)

    def spans(self) -> list[dict]:
        """Snapshot as dicts: {name, cat, ts (s), dur (s), thread, args}."""
        with self._lock:
            evs = list(self._buf)
        return [dict(name=n, cat=c, ts=ts, dur=dur, thread=thr, args=args)
                for n, c, ts, dur, thr, args in evs]


TRACER = Tracer()


def enable() -> None:
    TRACER.enabled = True


def disable() -> None:
    TRACER.enabled = False


class _NopSpan:
    """Shared do-nothing context manager: the disabled-tracing fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOP = _NopSpan()


class _Span:
    __slots__ = ("name", "cat", "attrs", "t0")

    def __init__(self, name: str, cat: str, attrs: dict):
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        TRACER.record(self.name, self.cat, self.t0, time.perf_counter(),
                      self.attrs)
        return False


def span(name: str, cat: str = "serve", **attrs):
    """``with span("seal"): ...`` — records a complete event when tracing
    is enabled; a shared no-op otherwise."""
    if not TRACER.enabled:
        return _NOP
    return _Span(name, cat, attrs)


def record(name: str, t0: float, t1: float, cat: str = "serve",
           **attrs) -> None:
    """Record a span from timestamps already measured (the engine's stage
    timers — no second clock read on the hot path)."""
    if TRACER.enabled:
        TRACER.record(name, cat, t0, t1, attrs)
