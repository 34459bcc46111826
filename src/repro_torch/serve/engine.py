"""Futures-based asynchronous query engine with deadline admission control
(the port's copy of ``repro/serve/engine.py``).

``QueryEngine.flush`` is synchronous: every caller blocks on the whole
micro-batch. :meth:`AsyncEngine.submit` instead enqueues one query into a
**bounded** request queue and returns a
:class:`concurrent.futures.Future` at once; a background dispatch thread
drains the queue into the engine's padding-ladder micro-batcher under a
**max-wait / max-batch** policy and resolves each future with a typed
outcome:

* :class:`Completed` — per-query top-k ids/dists, **bit-exact with the
  synchronous ``flush()`` path**: the dispatcher assembles exactly the
  arrays ``flush`` would, and every per-query result is independent of
  batch composition (the padding ladder serves PAD rows that match
  nothing).
* :class:`Rejected` — admission control shed the request: the queue was
  full at submit, or at dispatch ``queue_time + predicted_batch_cost``
  exceeded the request's deadline. ``Rejected("internal")`` covers the
  serving path itself failing: a backend exception or dispatch crash
  resolves every in-flight future typed, the supervised dispatch loop
  restarts with backoff, and exhausting the restart budget fails the
  queue and latches ``degraded`` — a future from this engine ALWAYS
  resolves.
* :class:`Degraded` — the fleet answered with no healthy replica left:
  sentinel neighbors plus the coverage fraction.

Batch cost is predicted per padding-ladder rung with an EWMA of measured
batch latencies. The backend returns host arrays (``QueryEngine`` copies
its results off the device), so a measured batch includes the card's
work. The clock is injectable (``clock=``), which makes shedding
deterministic under a fake clock in tests.

Every thread that serves (the dispatch thread, a fleet's ingest thread,
the caller) launches its CUDA work on the device's default stream, where
it serialises; results are numpy, never device tensors.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field

import numpy as np

from ..core.alphabet import PAD, encode
from ..faults import Supervisor, fault_point
from ..obs import REGISTRY, instant, new_trace_id, span, trace_context
from .metrics import Counters, Rolling

#: EWMA smoothing for the per-rung batch-cost model (higher = faster
#: adaptation to load shifts, lower = steadier admission decisions).
COST_ALPHA = 0.3

# registry families (children labeled by the async engine's name; the
# Rolling windows mirror into the *_seconds histograms, so per-process
# snapshots keep their exact window percentiles while the registry view
# merges across engines/processes)
_M_QUEUE = REGISTRY.histogram(
    "async_queue_seconds", "submit -> dispatch queue wait",
    labelnames=("engine",))
_M_TOTAL = REGISTRY.histogram(
    "async_total_seconds", "submit -> resolve request latency",
    labelnames=("engine",))
_M_REQS = REGISTRY.counter(
    "async_requests", "submitted requests by outcome (completed / "
    "degraded / shed_queue_full / shed_deadline / shed_shutdown / "
    "shed_internal)",
    labelnames=("engine", "outcome"))
_M_DEPTH = REGISTRY.gauge(
    "async_queue_depth", "queued requests at last dispatch",
    labelnames=("engine",))

_async_ids = itertools.count()


@dataclass(frozen=True)
class Completed:
    """A served request: top-k neighbor ids/dists (-1 padded), the index
    epoch the serving replica answered at (the result is exact for the
    index at that epoch), and queue/batch timing."""
    ids: np.ndarray
    dists: np.ndarray
    epoch: int | None
    queued_ms: float
    batch_ms: float

    @property
    def ok(self) -> bool:
        return True


@dataclass(frozen=True)
class Rejected:
    """A shed request. ``reason`` is one of ``"queue_full"`` (bounded
    queue was full at submit), ``"deadline"`` (queue time + predicted
    batch cost exceeded the request deadline at dispatch),
    ``"shutdown"`` (engine closed with the request still queued), or
    ``"internal"`` (the serving path itself failed — backend exception
    or dispatch-thread crash; ``detail`` names the error). A future from
    this engine ALWAYS resolves to a typed outcome: internal failures
    are rejections, never stranded futures."""
    reason: str
    queued_ms: float = 0.0
    predicted_ms: float = 0.0
    detail: str = ""

    @property
    def ok(self) -> bool:
        return False


@dataclass(frozen=True)
class Degraded:
    """A request served while NO healthy replica remained: sentinel
    ids/dists (no neighbors found), ``epoch=None``, the fleet's healthy
    ``coverage`` fraction at decision time, and the last error. Not
    ``ok`` — but not an exception either: closed-loop callers count
    degraded answers exactly like sheds, without try/except."""
    ids: np.ndarray
    dists: np.ndarray
    epoch: None
    coverage: float
    detail: str
    queued_ms: float = 0.0
    batch_ms: float = 0.0

    @property
    def ok(self) -> bool:
        return False

    @property
    def degraded(self) -> bool:
        return True


@dataclass
class _Request:
    row: np.ndarray
    length: int
    t_submit: float
    deadline: float | None          # absolute clock() seconds, or None
    trace: int = 0                  # trace ID minted at submit (obs.trace)
    future: Future = field(default_factory=Future)


def _resolve(fut: Future, value) -> None:
    """Resolve a future, tolerating caller-side cancellation."""
    try:
        fut.set_result(value)
    except InvalidStateError:
        pass


class AsyncEngine:
    """Background dispatch thread over a synchronous serving backend.

    ``backend`` is anything with a ``cfg`` (:class:`ServingConfig` — the
    ladder and max_batch come from there) and a ``query_batch(ids, lens)``
    returning ``(nid, nd)`` or ``(nid, nd, epoch)`` — a single
    :class:`~repro_torch.index.service.QueryEngine` or a
    :class:`~repro_torch.serve.fleet.ReplicaFleet`.

    * ``max_wait_ms`` — dispatch policy: a batch launches when it reaches
      ``cfg.max_batch`` requests or the oldest member has waited this
      long, whichever comes first (0 = greedy: take whatever is queued).
    * ``queue_depth`` — bound on queued requests; submits beyond it
      resolve immediately to ``Rejected("queue_full")``.
    * ``default_deadline_ms`` — applied to submits that pass no deadline
      (None = no deadline, never shed for time).
    * ``clock`` — injectable monotonic clock (tests use a fake one to
      make admission decisions deterministic).
    * ``start=False`` skips the thread; tests drive :meth:`_drain_once`.
    """

    def __init__(self, backend, *, max_wait_ms: float = 2.0,
                 queue_depth: int = 1024,
                 default_deadline_ms: float | None = None,
                 clock=time.monotonic, window: int = 4096,
                 name: str | None = None,
                 warmup=None, start: bool = True):
        self.backend = backend
        self.max_batch = int(backend.cfg.max_batch)
        self._ladder = tuple(backend.cfg.batch_ladder)
        self.max_wait = float(max_wait_ms) / 1e3
        self.default_deadline = (None if default_deadline_ms is None
                                 else float(default_deadline_ms) / 1e3)
        self._clock = clock
        self._q: queue.Queue = queue.Queue(maxsize=int(queue_depth))
        self._cost_ms: dict[int, float] = {}    # ladder rung -> EWMA ms
        self.name = name or f"async{next(_async_ids)}"
        self.counters = Counters("submitted", "completed", "degraded",
                                 "shed_queue_full", "shed_deadline",
                                 "shed_shutdown", "shed_internal",
                                 "batches")
        # exact window percentiles locally; merged histograms globally
        self.queue_lat = Rolling(window, _M_QUEUE.labels(engine=self.name))
        self.total_lat = Rolling(window, _M_TOTAL.labels(engine=self.name))
        self._m_reqs = _M_REQS
        self._m_depth = _M_DEPTH.labels(engine=self.name)
        self._closed = threading.Event()
        self._sup: Supervisor | None = None
        self._wedged = False
        if warmup is not None:      # every serving shape pre-traffic
            if isinstance(warmup, tuple):
                self.warmup(*warmup)
            else:
                self.warmup()
        if start:
            # supervised dispatch: a backend/dispatch crash resolves the
            # in-flight batch typed (inside _drain_once), then the
            # supervisor restarts the loop with backoff; exhausting the
            # restart budget fails the whole queue and latches degraded
            self._sup = Supervisor(
                f"dispatch-{self.name}",
                lambda: self._drain_once(timeout=0.02),
                on_giveup=self._fail_queue).start()

    # ------------------------------------------------------------ submit
    def submit(self, seq, *, deadline_ms: float | None = None) -> Future:
        """Enqueue one query (amino-acid string or encoded int8 row);
        returns a future resolving to :class:`Completed` or
        :class:`Rejected`. Never blocks: a full queue is an immediate
        typed rejection (back-pressure belongs to the caller, not a
        hidden ``put()`` stall)."""
        if isinstance(seq, str):
            row = np.asarray(encode(seq), np.int8)
        else:
            row = np.asarray(seq, np.int8).reshape(-1)
        now = self._clock()
        if deadline_ms is not None:
            deadline = now + float(deadline_ms) / 1e3
        elif self.default_deadline is not None:
            deadline = now + self.default_deadline
        else:
            deadline = None
        tid = new_trace_id()
        req = _Request(row, len(row), now, deadline, trace=tid)
        self.counters.bump("submitted")
        instant("submit", trace=[tid], engine=self.name, len=req.length)
        if self._closed.is_set():
            self._shed(req, "shutdown")
            return req.future
        if self._sup is not None and self._sup.degraded:
            # the dispatch loop gave up: nobody will ever drain the
            # queue — reject at the door instead of stranding the future
            self._shed(req, "internal",
                       detail=f"dispatch degraded: {self._sup.last_error}")
            return req.future
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._shed(req, "queue_full")
        return req.future

    def _shed(self, req: _Request, reason: str, **kw) -> None:
        self.counters.bump(f"shed_{reason}")
        self._m_reqs.inc(engine=self.name, outcome=f"shed_{reason}")
        instant("shed", trace=[req.trace], reason=reason)
        _resolve(req.future, Rejected(reason, **kw))

    def _fail_queue(self, exc: Exception | None = None) -> None:
        """Resolve every queued future with Rejected("internal") — runs
        when the supervised dispatch loop exhausts its restart budget
        (nothing may strand) and from close() for leftovers."""
        detail = f"{type(exc).__name__}: {exc}" if exc is not None else ""
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            self._shed(r, "internal", detail=detail)

    def pending(self) -> int:
        return self._q.qsize()

    # ------------------------------------------------------------ dispatch
    def _rung(self, b: int) -> int:
        """Padding-ladder rung a batch of ``b`` requests lands on (the
        cost-model key — mirrors ``QueryEngine._pad_shapes``)."""
        ladder = [x for x in self._ladder if x >= b]
        return min(ladder) if ladder else self.max_batch

    def predicted_ms(self, b: int) -> float:
        """Predicted wall-clock of serving a batch of ``b`` requests:
        the EWMA for its ladder rung; optimistic 0 until that rung has
        been measured (first batches admit everything, then the model
        takes over)."""
        return self._cost_ms.get(self._rung(b), 0.0)

    def _update_cost(self, b: int, seconds: float) -> None:
        r = self._rung(b)
        ms = seconds * 1e3
        old = self._cost_ms.get(r)
        self._cost_ms[r] = ms if old is None else \
            COST_ALPHA * ms + (1.0 - COST_ALPHA) * old

    def _collect(self, timeout: float) -> list:
        """Gather one batch under the max-wait/max-batch policy."""
        try:
            batch = [self._q.get(timeout=timeout)]
        except queue.Empty:
            return []
        t_first = self._clock()
        while len(batch) < self.max_batch:
            wait = self.max_wait - (self._clock() - t_first)
            if wait <= 0:
                try:                        # greedy: only what's queued
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            else:
                try:
                    batch.append(self._q.get(timeout=wait))
                except queue.Empty:
                    break
        return batch

    def _drain_once(self, timeout: float = 0.05) -> int:
        """One dispatch iteration: collect, admit/shed, serve, resolve.
        Returns the number of requests taken off the queue."""
        batch = self._collect(timeout)
        if not batch:
            return 0
        self._m_depth.set(self._q.qsize())
        now = self._clock()
        predicted = self.predicted_ms(len(batch))
        admitted = []
        for r in batch:
            # queue time is already inside `now`; shedding asks whether
            # the batch this request would join can finish by its deadline
            if r.deadline is not None and now + predicted / 1e3 > r.deadline:
                self._shed(r, "deadline",
                           queued_ms=(now - r.t_submit) * 1e3,
                           predicted_ms=predicted)
            else:
                admitted.append(r)
        if not admitted:
            return len(batch)
        n = len(admitted)
        L = max(r.length for r in admitted)
        ids = np.full((n, max(L, 1)), PAD, np.int8)
        lens = np.zeros(n, np.int32)
        for j, r in enumerate(admitted):
            ids[j, :r.length] = r.row
            lens[j] = r.length
        tids = tuple(r.trace for r in admitted)
        t0 = self._clock()
        # every span beneath (route, query_batch, probe, ring, rerank) is
        # tagged with this batch's query trace IDs via the contextvar
        try:
            with trace_context(tids):
                with span("dispatch", n=n, engine=self.name,
                          predicted_ms=round(predicted, 3)):
                    fault_point("engine.dispatch", n=n)
                    out = self.backend.query_batch(ids, lens)
        except Exception as e:          # noqa: BLE001 — the batch must
            # resolve typed BEFORE the crash propagates: the supervisor
            # restarts the loop, but these futures' fate is sealed here
            detail = f"{type(e).__name__}: {e}"
            for r in admitted:
                self._shed(r, "internal", detail=detail,
                           queued_ms=(t0 - r.t_submit) * 1e3)
            raise
        dt = self._clock() - t0
        done = self._clock()
        if getattr(out, "degraded", False):
            # the fleet had no healthy replica: typed partial answers
            # with the coverage fraction, not Completed (and not a cost
            # sample — nothing was actually served)
            for j, r in enumerate(admitted):
                self.counters.bump("degraded")
                self._m_reqs.inc(engine=self.name, outcome="degraded")
                self.total_lat.add(done - r.t_submit)
                instant("resolve_degraded", trace=[r.trace],
                        engine=self.name, coverage=out.coverage)
                _resolve(r.future, Degraded(
                    out.ids[j], out.dists[j], None, out.coverage,
                    out.detail, queued_ms=(t0 - r.t_submit) * 1e3,
                    batch_ms=dt * 1e3))
            return len(batch)
        if len(out) == 3:
            nid, nd, epoch = out
        else:
            nid, nd = out
            idx = getattr(self.backend, "index", None)
            epoch = idx.epoch if idx is not None else None
        self._update_cost(n, dt)
        self.counters.bump("batches")
        for j, r in enumerate(admitted):
            self.counters.bump("completed")
            self._m_reqs.inc(engine=self.name, outcome="completed")
            self.queue_lat.add(t0 - r.t_submit)
            self.total_lat.add(done - r.t_submit)
            instant("resolve", trace=[r.trace], engine=self.name)
            _resolve(r.future, Completed(
                nid[j], nd[j], epoch,
                queued_ms=(t0 - r.t_submit) * 1e3, batch_ms=dt * 1e3))
        return len(batch)

    # ------------------------------------------------------------ warmup
    def warmup(self, q_ids=None, q_lens=None, *,
               max_len: int | None = None) -> int:
        """Run every (batch-rung, length-quantum) serving shape on the
        backend before traffic arrives (delegates to the backend's own
        ``warmup`` — :meth:`QueryEngine.warmup` /
        :meth:`ReplicaFleet.warmup`); pass ``warmup=True`` or
        ``warmup=(q_ids, q_lens)`` at construction to do this
        automatically. Returns the number of shapes warmed."""
        wu = getattr(self.backend, "warmup", None)
        if wu is None:
            return 0
        return wu(q_ids, q_lens, max_len=max_len)

    # ------------------------------------------------------------ lifecycle
    def close(self, timeout: float = 30.0) -> bool:
        """Stop dispatch; queued-but-unserved requests resolve to
        ``Rejected("shutdown")`` (a future from this engine always
        resolves). Returns False — and latches ``wedged`` in stats —
        when the dispatch thread failed to join within ``timeout``: a
        wedged thread is reported, never silently abandoned."""
        if self._closed.is_set():
            return not self._wedged
        self._closed.set()
        clean = True
        if self._sup is not None:
            clean = self._sup.stop(timeout=timeout)
            if not clean:
                self._wedged = True
                instant("close_wedged", cat="fault", engine=self.name,
                        timeout_s=timeout)
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            self._shed(r, "shutdown")
        return clean

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        """Engine-level counters + rolling queue/total latency percentiles
        + the cost model, with the backend's own stats() nested under
        ``backend`` (per-stage timers, truncations, replica epochs)."""
        out = dict(
            pending=self.pending(),
            counters=self.counters.snapshot(),
            queue=self.queue_lat.snapshot(),
            latency=self.total_lat.snapshot(),
            cost_model_ms={str(k): round(v, 3)
                           for k, v in sorted(self._cost_ms.items())},
            wedged=self._wedged,
            backend=self.backend.stats(),
        )
        if self._sup is not None:
            out["dispatch"] = self._sup.stats()
        return out
