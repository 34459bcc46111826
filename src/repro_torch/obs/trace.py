"""Structured tracing: spans, per-query trace IDs, Chrome/Perfetto export.

The port's copy of ``repro/obs/trace.py``. Records land in a bounded,
thread-safe ring buffer and export as Chrome ``trace_event`` JSON, which
opens in ``chrome://tracing`` or Perfetto with every serving thread on one
timeline.

* **Disabled tracing is one branch**: :func:`span` checks a flag and
  returns a shared no-op context manager, :func:`record` and
  :func:`instant` return at once. Tracing is off by default.
* **Trace IDs are minted at the front door and ride a contextvar**:
  ``AsyncEngine.submit`` mints one ID per query; the dispatch thread
  enters :func:`trace_context` with the IDs of the batch it assembled, so
  every span recorded beneath it (router, replica, ring probe, re-rank)
  carries the queries it served.
* **Bounded buffer**: a ``deque(maxlen=capacity)``; the newest spans win.
* **One clock with the profiler**: spans are stamped with
  ``time.perf_counter`` and placed on the wall clock (``time.time_ns``,
  ns since the Unix epoch) that ``torch.profiler`` (kineto) stamps its
  events on, through one (``perf_counter_ns``, ``time_ns``) pair the
  tracer reads when it is made. ``spans()`` gives ``ts`` in wall-clock
  seconds. A profiler's ``export_chrome_trace`` file writes its events
  relative to its ``baseTimeNanoseconds``: ``export(path, merge=that
  file)`` writes one file with both, on that base, which Perfetto opens
  as one timeline. The spans are not ``record_function`` ranges, so they
  add nothing to the profiler's device-side annotations.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque

__all__ = [
    "TRACER", "Tracer", "span", "instant", "record", "new_trace_id",
    "trace_context", "current_trace", "enable", "disable",
]

#: trace IDs of the queries the current thread is doing work for (a
#: tuple: a dispatch batch serves many queries at once)
_TRACE_CTX: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_trace", default=())

_ids = itertools.count(1)       # CPython next() is atomic


def new_trace_id() -> int:
    """Mint a process-unique trace ID (one per submitted query)."""
    return next(_ids)


@contextlib.contextmanager
def trace_context(ids: tuple):
    """Tag every span recorded in this context with ``ids`` (the queries
    the enclosed work serves). Nesting replaces, not extends."""
    tok = _TRACE_CTX.set(tuple(ids))
    try:
        yield
    finally:
        _TRACE_CTX.reset(tok)


def current_trace() -> tuple:
    return _TRACE_CTX.get()


class Tracer:
    """Bounded thread-safe span buffer + Chrome trace_event export."""

    def __init__(self, capacity: int = 65536):
        self.enabled = False
        self._buf: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        # the epoch: one perf_counter reading and the wall clock beside it
        self._perf0 = time.perf_counter_ns() / 1e9
        self._wall0_ns = time.time_ns()
        self._dropped = 0

    # -------------------------------------------------------------- control
    def enable(self, capacity: int | None = None) -> None:
        with self._lock:
            if capacity is not None:
                self._buf = deque(self._buf, maxlen=int(capacity))
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    # -------------------------------------------------------------- record
    def record(self, name: str, cat: str, t0: float, t1: float | None,
               attrs: dict | None = None) -> None:
        """Append one span (t0/t1 are ``perf_counter`` seconds; ``t1=None``
        records an instant event). Auto-tags the current trace context."""
        args = dict(attrs) if attrs else {}
        if "trace" not in args:
            trace = _TRACE_CTX.get()
            if trace:
                args["trace"] = list(trace)
        ev = (name, cat, t0 - self._perf0, None if t1 is None else t1 - t0,
              threading.get_ident(), threading.current_thread().name, args)
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append(ev)

    # -------------------------------------------------------------- read
    def spans(self) -> list[dict]:
        """Snapshot as dicts: {name, cat, ts (wall-clock s since the Unix
        epoch), dur (s or None), tid, thread, args}; ``args["trace"]``
        holds the query trace IDs."""
        with self._lock:
            evs = list(self._buf)
        wall0 = self._wall0_ns / 1e9
        return [dict(name=n, cat=c, ts=wall0 + ts, dur=dur, tid=tid,
                     thread=thr, args=args)
                for n, c, ts, dur, tid, thr, args in evs]

    def chrome_trace(self, base_ns: int = 0) -> dict:
        """Chrome ``trace_event`` JSON object: complete ("X") events in
        microseconds of the wall clock since ``base_ns`` (ns since the Unix
        epoch), instants as "i" events, thread names as metadata ("M")
        events."""
        pid = os.getpid()
        events = []
        threads = {}
        with self._lock:
            evs = list(self._buf)
            dropped = self._dropped
        origin_us = (self._wall0_ns - int(base_ns)) / 1e3
        for name, cat, ts, dur, tid, thread, args in evs:
            threads.setdefault(tid, thread)
            ev = {"name": name, "cat": cat, "pid": pid, "tid": tid,
                  "ts": origin_us + ts * 1e6, "args": args}
            if dur is None:
                ev.update(ph="i", s="t")
            else:
                ev.update(ph="X", dur=dur * 1e6)
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": thread}} for tid, thread in threads.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": dropped}}

    def export(self, path, *, merge=None) -> int:
        """Write the Chrome trace JSON; returns the number of events. With
        ``merge=`` the path of a ``torch.profiler`` ``export_chrome_trace``
        file, write that trace with these spans added on its timeline."""
        if merge is None:
            obj = self.chrome_trace()
        else:
            with open(merge) as fh:
                obj = json.load(fh)
            ours = self.chrome_trace(obj.get("baseTimeNanoseconds", 0))
            obj["traceEvents"] = obj.get("traceEvents", []) + \
                ours["traceEvents"]
        with open(path, "w") as fh:
            json.dump(obj, fh)
        return len(obj["traceEvents"])


TRACER = Tracer()


def enable(capacity: int | None = None) -> None:
    TRACER.enable(capacity)


def disable() -> None:
    TRACER.disable()


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


def instant(name: str, cat: str = "serve", **attrs) -> None:
    """Record a zero-duration marker (submit, resolve, shed, crash)."""
    if TRACER.enabled:
        TRACER.record(name, cat, time.perf_counter(), None, attrs)


def record(name: str, t0: float, t1: float, cat: str = "serve",
           **attrs) -> None:
    """Record a span from timestamps already measured (the engine's stage
    timers — no second clock read on the hot path)."""
    if TRACER.enabled:
        TRACER.record(name, cat, t0, t1, attrs)
