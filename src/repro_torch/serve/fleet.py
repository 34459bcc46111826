"""Replica fleet: N sharded serving replicas behind a router + live ingest
(the port's copy of ``repro/serve/fleet.py``).

One :class:`~repro_torch.index.store.SignatureIndex` (the corpus is one
artifact), N :class:`~repro_torch.index.shard.ShardedIndex` replicas over
it, each wrapped in its own :class:`~repro_torch.index.service.QueryEngine`
(every replica keeps its own grow-and-retry cap and serving stats).

**Router** — ``query_batch`` picks the replica with the fewest
outstanding batches (ties broken least-recently-used), *skipping* any
replica whose lock is held (mid-refresh/compaction) when a free one
exists: while the ingest thread swaps one replica's slabs, traffic flows
to the others, and if every replica is busy the request waits on the
best one rather than failing.

**Ingest loop** — a background thread drains ``ingest()`` batches:
``index.add()`` (+ seal) under the shared lifecycle lock, then a rolling
per-replica delta ``refresh()`` under each replica's serving lock, then —
every ``minor_compact_every`` ingests — a rolling serving-side minor
compaction (``ShardedIndex.compact()``: the delta slab folds into the
base; the index's segments are untouched). Every handoff is epoch-tagged:
``query_batch`` returns the delta epoch the serving replica answered at,
so each result is exact for the index at a stated epoch.

**Failure model** — a replica that raises out of ``query_batch`` is
*tracked*: consecutive failures past ``fail_threshold`` quarantine it;
after ``quarantine_s`` a single **half-open probe** is admitted — success
readmits the replica, failure re-quarantines it for twice as long. A
failed batch gets **one bounded retry** on a different healthy replica.
With *no* healthy replica left, ``query_batch`` returns a typed
:class:`DegradedBatch` (coverage fraction attached) instead of raising.
The ingest loop runs under a
:class:`~repro_torch.faults.supervisor.Supervisor`: an ingest crash
resolves the waiter's :class:`IngestTicket` with the error attached, and
the loop restarts with backoff.

Thread-safety invariants (``tests/test_torch_serve.py`` races them):

* one **lifecycle lock** (installed as every replica's
  ``ShardedIndex.refresh_lock``) serializes all index mutation —
  ``add``/``seal``/merge/partition — against every replica's staleness
  check and refresh, so a probe never sees half-sealed segments;
* one **serving lock per replica** serializes that replica's slab swaps
  against its probes, so a ring never runs on half-swapped slabs;
* lock order is always replica lock → lifecycle lock (the inline
  ``_refresh_if_stale`` inside ``topk`` takes them in that order, and so
  does the ingest loop), so the pair cannot deadlock;
* replica **health fields** (fails / quarantined_until / probe_inflight)
  are read and written only under the pick lock.

Every replica's CUDA work (the ring, the re-rank's kernel K3) goes to the
device's default stream, whichever thread issues it; injected faults are
Python-level ``fault_point`` sites — a real device fault would poison the
CUDA context of every replica.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np

from ..faults import Supervisor, fault_point
from ..index.service import QueryEngine, ServingConfig
from ..obs import REGISTRY, instant, span
from ..index.shard import ShardedIndex
from .metrics import Counters

# registry-side mirrors of the fault-path counters
_M_RETRIES = REGISTRY.counter(
    "router_retries", "failed batches retried on another replica, by "
    "outcome (attempted / succeeded)", labelnames=("outcome",))
_M_QUAR = REGISTRY.counter(
    "replica_quarantine_events", "replica health transitions "
    "(quarantined / probed / readmitted)", labelnames=("event",))
_M_DEGRADED = REGISTRY.counter(
    "degraded_batches", "batches answered degraded because no healthy "
    "replica remained")


class IngestTicket(threading.Event):
    """The waitable handle :meth:`ReplicaFleet.ingest` returns. Always
    set once the batch's fate is known; ``error`` is None on success and
    a ``"Type: message"`` string when the ingest crashed or the fleet
    closed with the batch still queued — waiters MUST check it."""

    def __init__(self):
        super().__init__()
        self.error: str | None = None

    @property
    def ok(self) -> bool:
        return self.is_set() and self.error is None


class DegradedBatch:
    """The typed answer when no healthy replica could serve a batch:
    sentinel ids/dists (no neighbors), ``epoch=None`` (no index state
    answered), a ``coverage`` fraction (healthy replicas / fleet size at
    decision time — 0.0 when everything was down) and the last error.
    Duck-typed with ``degraded=True`` so the async engine detects it
    without importing this module."""

    degraded = True

    def __init__(self, n: int, k: int, coverage: float, detail: str):
        self.ids = np.full((n, k), -1, np.int32)
        self.dists = np.full((n, k), np.float32(np.inf), np.float32)
        self.epoch = None
        self.coverage = float(coverage)
        self.detail = detail

    def __repr__(self):
        return (f"DegradedBatch(n={len(self.ids)}, "
                f"coverage={self.coverage:.2f}, detail={self.detail!r})")


class _Replica:
    __slots__ = ("name", "engine", "sharded", "lock", "outstanding",
                 "last_used", "fails", "quarantined_until", "quarantine_s",
                 "probe_inflight")

    def __init__(self, name: str, engine: QueryEngine,
                 sharded: ShardedIndex):
        self.name = name
        self.engine = engine
        self.sharded = sharded
        self.lock = threading.Lock()    # serving lock: probes vs slab swaps
        self.outstanding = 0
        self.last_used = 0
        # health (guarded by the fleet's pick lock)
        self.fails = 0                  # consecutive query failures
        self.quarantined_until = 0.0    # clock() time; 0.0 = not quarantined
        self.quarantine_s = 0.0         # current quarantine span (doubles)
        self.probe_inflight = False     # half-open: one probe at a time


class ReplicaFleet:
    """N serving replicas over one index, with live background ingest.

    Exposes the async-engine backend protocol: ``cfg`` and
    ``query_batch(ids, lens) -> (nid, nd, epoch)`` — plug a fleet
    straight into :class:`~repro_torch.serve.engine.AsyncEngine`.

    One :class:`ServingConfig` governs every replica, including the
    re-rank DP routing knobs (``dp_kernel``/``gap_mode``/``gap_open``/
    ``gap_extend``). ``devices`` places each replica's shards (one entry
    per shard, as :class:`ShardedIndex` takes it; default one shard on
    the index's device).
    """

    def __init__(self, index, cfg: ServingConfig | None = None, *,
                 n_replicas: int = 2, devices=None, ref_seqs=None,
                 minor_compact_every: int = 4, warmup=None,
                 start_ingest: bool = True, fail_threshold: int = 3,
                 quarantine_s: float = 1.0, max_retries: int = 1,
                 clock=time.monotonic):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.index = index
        self.cfg = cfg or ServingConfig()
        self.minor_compact_every = int(minor_compact_every)
        self.fail_threshold = int(fail_threshold)
        self.base_quarantine_s = float(quarantine_s)
        self.max_retries = int(max_retries)
        self._clock = clock
        # ONE lifecycle lock shared by every replica and the ingest
        # thread (see module docstring); RLock because refresh() both
        # takes it and runs under it from _refresh_if_stale.
        self._lifecycle = threading.RLock()
        self._replicas: list[_Replica] = []
        for i in range(n_replicas):
            sharded = ShardedIndex(index, devices)
            sharded.refresh_lock = self._lifecycle
            engine = QueryEngine(index, self.cfg, sharded=sharded,
                                 ref_seqs=ref_seqs, name=f"replica{i}")
            self._replicas.append(_Replica(f"replica{i}", engine, sharded))
        self._pick_lock = threading.Lock()
        self._ticket = 0
        self.counters = Counters("batches", "ingests", "minor_compactions",
                                 "major_compactions", "waited_busy",
                                 "retries", "retry_success",
                                 "replica_failures", "replica_quarantines",
                                 "replica_probes", "replica_readmissions",
                                 "degraded_batches", "ingest_failures")
        self._ingest_q: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._ingest_sup: Supervisor | None = None
        if warmup is not None:      # every serving shape pre-traffic
            if isinstance(warmup, tuple):
                self.warmup(*warmup)
            else:
                self.warmup()
        if start_ingest:
            self._ingest_sup = Supervisor(
                "serve-ingest", self._ingest_once,
                idle_sleep_s=0.0).start()

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    # ------------------------------------------------------------ routing
    def _pick(self, exclude=()) -> _Replica | None:
        """Least-outstanding *healthy* replica, skipping locked ones when
        possible; ACQUIRES the winner's serving lock (caller releases).
        Quarantined replicas are offered no traffic until their
        quarantine expires, then exactly one half-open probe at a time.
        Returns None when no eligible replica exists (all quarantined or
        excluded) — the caller degrades instead of waiting forever."""
        now = self._clock()
        with self._pick_lock:
            self._ticket += 1
            order = []
            for r in self._replicas:
                if r in exclude:
                    continue
                if r.quarantined_until > 0.0 and (
                        now < r.quarantined_until or r.probe_inflight):
                    continue        # still serving quarantine / probe out
                order.append(r)
            order.sort(key=lambda r: (r.outstanding, r.last_used))
        if not order:
            return None
        picked = None
        for rep in order:
            if rep.lock.acquire(blocking=False):
                picked = rep
                break
        if picked is None:
            # every eligible replica busy (mid-batch or mid-refresh):
            # wait on the least-loaded one — requests queue behind it
            self.counters.bump("waited_busy")
            picked = order[0]
            picked.lock.acquire()
        if picked.quarantined_until > 0.0:
            with self._pick_lock:   # half-open: this batch IS the probe
                picked.probe_inflight = True
            self.counters.bump("replica_probes")
            _M_QUAR.inc(event="probed")
        return picked

    def _record_failure(self, rep: _Replica, err: Exception) -> None:
        """Health bookkeeping after a replica raised out of a batch."""
        self.counters.bump("replica_failures")
        now = self._clock()
        with self._pick_lock:
            rep.fails += 1
            if rep.probe_inflight:
                # the half-open probe failed: back to quarantine, twice
                # as long — a flapping replica backs itself off
                rep.probe_inflight = False
                rep.quarantine_s *= 2.0
                rep.quarantined_until = now + rep.quarantine_s
                quarantined = True
            elif (rep.quarantined_until == 0.0
                  and rep.fails >= self.fail_threshold):
                rep.quarantine_s = self.base_quarantine_s
                rep.quarantined_until = now + rep.quarantine_s
                quarantined = True
            else:
                quarantined = False
        if quarantined:
            self.counters.bump("replica_quarantines")
            _M_QUAR.inc(event="quarantined")
            instant("replica_quarantined", cat="fault", replica=rep.name,
                    fails=rep.fails, quarantine_s=rep.quarantine_s,
                    error=type(err).__name__)

    def _record_success(self, rep: _Replica) -> None:
        readmitted = False
        with self._pick_lock:
            rep.fails = 0
            if rep.probe_inflight:  # half-open probe answered: readmit
                rep.probe_inflight = False
                rep.quarantined_until = 0.0
                rep.quarantine_s = 0.0
                readmitted = True
        if readmitted:
            self.counters.bump("replica_readmissions")
            _M_QUAR.inc(event="readmitted")
            instant("replica_readmitted", cat="fault", replica=rep.name)

    def _query_on(self, rep: _Replica, ids, lens):
        """One serving attempt on ``rep`` (its lock is held on entry and
        released here). ``replica.query`` is the fault site."""
        try:
            with self._pick_lock:
                rep.outstanding += 1
                rep.last_used = self._ticket
            with span("route", replica=rep.name):
                fault_point("replica.query", replica=rep.name)
                nid, nd = rep.engine.query_batch(ids, lens)
            # read under rep.lock: this is exactly what the batch saw
            epoch = rep.sharded.epoch[1]
        finally:
            with self._pick_lock:
                rep.outstanding -= 1
            rep.lock.release()
        return nid, nd, epoch

    def coverage(self) -> float:
        """Fraction of replicas currently eligible for traffic."""
        now = self._clock()
        with self._pick_lock:
            up = sum(1 for r in self._replicas
                     if r.quarantined_until == 0.0
                     or (now >= r.quarantined_until
                         and not r.probe_inflight))
        return up / len(self._replicas)

    def query_batch(self, ids, lens):
        """Serve one batch on the best healthy replica: (nid, nd, epoch)
        with ``epoch`` the delta epoch (index segment count) the replica
        answered at — results are bit-exact with a synchronous
        ``topk_probe`` over the index at exactly that epoch. A replica
        failure gets up to ``max_retries`` retries on *other* healthy
        replicas (still bit-exact: the retry's answer carries its own
        epoch). With no healthy replica left the batch resolves to a
        typed :class:`DegradedBatch` instead of raising."""
        tried: list[_Replica] = []
        last_err: Exception | None = None
        for attempt in range(1 + self.max_retries):
            rep = self._pick(exclude=tried)
            if rep is None:
                break               # nobody healthy left to try
            if attempt > 0:
                self.counters.bump("retries")
                _M_RETRIES.inc(outcome="attempted")
                instant("batch_retry", cat="fault", replica=rep.name,
                        attempt=attempt)
            try:
                out = self._query_on(rep, ids, lens)
            except Exception as e:      # noqa: BLE001 — any backend error
                last_err = e
                tried.append(rep)
                self._record_failure(rep, e)
                continue
            self._record_success(rep)
            if attempt > 0:
                self.counters.bump("retry_success")
                _M_RETRIES.inc(outcome="succeeded")
            self.counters.bump("batches")
            return out
        # graceful degradation: typed partial result, never an exception
        self.counters.bump("degraded_batches")
        _M_DEGRADED.inc()
        detail = (f"{type(last_err).__name__}: {last_err}" if last_err
                  else "no healthy replica")
        cov = self.coverage()
        instant("degraded_batch", cat="fault", coverage=cov, detail=detail)
        return DegradedBatch(len(lens), self.cfg.k, cov, detail)

    # ------------------------------------------------------------ ingest
    def ingest(self, ref_ids, ref_lens) -> IngestTicket:
        """Queue a reference batch for background ingest; returns an
        :class:`IngestTicket` set once the batch's fate is known — every
        replica serves the new segment (``ticket.ok``) or the ingest
        crashed (``ticket.error`` holds the typed error; the supervisor
        restarts the loop for later batches). Serving never stops:
        replicas refresh one at a time off-rotation."""
        ev = IngestTicket()
        self._ingest_q.put((np.asarray(ref_ids, np.int8),
                            np.asarray(ref_lens, np.int32), ev))
        return ev

    def _ingest_once(self) -> int:
        """One supervised ingest iteration (see Supervisor.run_once):
        returns items applied; an exception is a crash — the ticket was
        already resolved with the error by :meth:`_apply_ingest`."""
        try:
            item = self._ingest_q.get(timeout=0.05)
        except queue.Empty:
            return 0
        self._apply_ingest(*item)
        return 1

    def _apply_ingest(self, ref_ids, ref_lens, ev: IngestTicket) -> None:
        try:
            fault_point("ingest.apply", rows=len(ref_lens))
            with span("ingest", cat="lifecycle", rows=len(ref_lens),
                      epoch=self.index.epoch):
                with self._lifecycle:
                    self.index.add(ref_ids, ref_lens)
                    self.index.seal()   # segments exist before replicas look
                for rep in self._replicas:  # rolling: one replica at a time
                    with rep.lock:
                        rep.sharded.refresh()
            self.counters.bump("ingests")
            if self.minor_compact_every > 0 and \
                    self.counters["ingests"] % self.minor_compact_every == 0:
                with span("minor_compaction", cat="lifecycle",
                          epoch=self.index.epoch):
                    for rep in self._replicas:
                        with rep.lock:
                            rep.sharded.compact()
                self.counters.bump("minor_compactions")
        except Exception as e:          # noqa: BLE001 — resolve, then crash
            self.counters.bump("ingest_failures")
            ev.error = f"{type(e).__name__}: {e}"
            ev.set()                    # the waiter wakes WITH the error —
            raise                       # and the supervisor counts the crash
        ev.set()

    def drain_ingest(self, timeout: float = 60.0) -> bool:
        """Block until every queued ingest has been taken up."""
        t0 = time.monotonic()
        while not self._ingest_q.empty():
            if time.monotonic() - t0 > timeout:
                return False
            time.sleep(0.005)
        return True

    def compact_index(self) -> None:
        """Major compaction: fold the index's segments into one
        (``generation`` bump) and re-place every replica — rolling, so
        serving stays live; results are identical before and after."""
        with span("major_compaction", cat="lifecycle",
                  epoch=self.index.epoch,
                  generation=self.index.generation):
            with self._lifecycle:
                self.index.compact()
            for rep in self._replicas:
                with rep.lock:
                    rep.sharded.refresh()   # generation bump -> re-place
        self.counters.bump("major_compactions")

    # ------------------------------------------------------------ warmup
    def warmup(self, q_ids=None, q_lens=None, *,
               max_len: int | None = None) -> int:
        """Warm EVERY replica's engine directly (the router would send all
        warmup batches to whichever replica is free, leaving the others
        cold); same per-(rung, length-quantum) sweep as
        :meth:`QueryEngine.warmup`. Returns total shapes warmed. Each
        replica's grow-and-retry probe cap settles on its own, which is
        the point of warming each."""
        total = 0
        for rep in self._replicas:
            with rep.lock:
                total += rep.engine.warmup(q_ids, q_lens, max_len=max_len)
                rep.engine.reset_stats()    # warmup batches aren't traffic
        return total

    # ------------------------------------------------------------ lifecycle
    def close(self, timeout: float = 30.0) -> bool:
        """Stop the ingest supervisor and resolve any still-queued
        tickets with a shutdown error (an IngestTicket from this fleet
        always resolves). Returns False when the ingest thread failed to
        join — wedged, which the caller must surface, not swallow."""
        self._closed.set()
        clean = True
        if self._ingest_sup is not None:
            clean = self._ingest_sup.stop(timeout=timeout)
        while True:
            try:
                *_ids, ev = self._ingest_q.get_nowait()
            except queue.Empty:
                break
            ev.error = "Shutdown: fleet closed before this batch applied"
            ev.set()
        return clean

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        """Fleet counters + per-replica serving stats, epochs, and health
        (consecutive fails / quarantine state), plus the ingest
        supervisor's crash accounting."""
        now = self._clock()
        reps = []
        for rep in self._replicas:
            s = rep.engine.stats()
            s["name"] = rep.name
            s["outstanding"] = rep.outstanding
            s["epoch"] = tuple(rep.sharded.epoch)
            with self._pick_lock:
                s["health"] = dict(
                    fails=rep.fails,
                    quarantined=(rep.quarantined_until > 0.0
                                 and now < rep.quarantined_until),
                    quarantine_s=rep.quarantine_s,
                    probe_inflight=rep.probe_inflight)
            reps.append(s)
        out = dict(
            n_replicas=self.n_replicas,
            coverage=self.coverage(),
            counters=self.counters.snapshot(),
            index_epoch=self.index.epoch,
            index_generation=self.index.generation,
            replicas=reps,
        )
        if self._ingest_sup is not None:
            out["ingest"] = self._ingest_sup.stats()
        return out
