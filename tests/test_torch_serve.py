"""The port's serving tier (``repro_torch.serve``), its supervisor
(``repro_torch.faults.Supervisor``) and the observability it reports
through (``repro_torch.obs``), on the CPU, mirroring the reference's
``tests/test_serve.py`` and the supervisor, engine and fleet cases of
``tests/test_faults.py``:

* async results equal the synchronous ``flush()`` bit for bit, however
  the submits batch, and equal the reference engine's answers;
* deadline shedding is a pure function of submit times, deadlines and the
  cost model under an injected clock — the reference's engine makes the
  same decisions on the same script;
* a fleet racing a live ingest and compactions answers exactly at the
  epoch it reports;
* the same seed gives the reference's backoff sequence, the same fault
  script the reference's ledger, and the same observations the
  reference's Prometheus text.

Every wait on a thread, queue, event or future carries a timeout."""
import threading
import time

import numpy as np
import pytest

from repro.faults import FaultPlan as JPlan, Supervisor as JSupervisor
from repro.faults import fault_point as j_fault_point
from repro.index import QueryEngine as JEngine, ServingConfig as JScfg
from repro.index.store import SignatureIndex as JIndex
from repro.core.pipeline import LSHConfig as JCfg
from repro.obs.registry import Registry as JRegistry, Histogram as JHist
from repro.obs.trace import Tracer as JTracer
from repro.serve import AsyncEngine as JAsync
from repro.serve.metrics import Rolling as JRolling

from repro_torch.core.pipeline import LSHConfig
from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                        make_protein_sets)
from repro_torch.faults import FaultPlan, Supervisor
from repro_torch.faults import fault_point
from repro_torch.index import (QueryEngine, ServingConfig, ShardedIndex,
                               SignatureIndex)
from repro_torch.obs import Histogram, Registry, Tracer
from repro_torch.obs import current_trace, new_trace_id, trace_context
from repro_torch.serve import (AsyncEngine, Completed, Degraded,
                               DegradedBatch, Rejected, ReplicaFleet)
from repro_torch.serve.engine import COST_ALPHA
from repro_torch.serve.metrics import Counters, Rolling

KW = dict(k=3, T=13, f=32, d=1)
CFG = LSHConfig(**KW)
# probe mode on both sides of every parity assertion: the fleet serves the
# sharded probe ring, while mode="auto" below dense_threshold would take
# the dense path (which ranks ALL refs — other semantics)
SCFG = ServingConfig(k=5, max_batch=8, mode="probe")
T = 30          # seconds: the bound on every wait in this file


@pytest.fixture(scope="module")
def data():
    return make_protein_sets(SyntheticProteinConfig(
        n_refs=120, n_homolog_queries=16, n_decoy_queries=16,
        ref_len_mean=90, ref_len_std=12, sub_rates=(0.04, 0.1), seed=77))


def _build(data, upto=None):
    return SignatureIndex.build(CFG, data["ref_ids"][:upto],
                                data["ref_lens"][:upto], device="cpu")


@pytest.fixture(scope="module")
def index(data):
    idx = _build(data)
    idx._ensure_built()
    return idx


def _rows(data):
    """Queries as length-trimmed rows (what a caller submits)."""
    return [np.asarray(data["query_ids"][j][:data["query_lens"][j]], np.int8)
            for j in range(len(data["query_lens"]))]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _FakeBackend:
    """Minimal AsyncEngine backend: fails the first ``fail_first`` calls,
    then answers with constant neighbors at epoch 7."""

    def __init__(self, fail_first=0, block_on=None):
        self.cfg = SCFG
        self.calls = 0
        self.fail_first = fail_first
        self.block_on = block_on
        self.index = None

    def query_batch(self, ids, lens):
        self.calls += 1
        if self.block_on is not None:
            self.block_on.wait(timeout=T)
        if self.calls <= self.fail_first:
            raise RuntimeError(f"backend down (call {self.calls})")
        n = len(lens)
        return (np.zeros((n, SCFG.k), np.int32),
                np.zeros((n, SCFG.k), np.float32), 7)

    def stats(self):
        return {}


def _wait_until(cond, what):
    deadline = time.monotonic() + T
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


# ------------------------------------------------------------ bit-exactness
def test_async_matches_flush_and_the_reference_bitexact(data, index):
    """Every async result == the synchronous flush() result for the same
    query, despite other batch compositions — and == the reference
    engine's flush over the same corpus."""
    rows = _rows(data)
    sync = QueryEngine(index, SCFG)
    for r in rows:
        sync.submit(r)
    want = sync.flush()
    jeng = JEngine(JIndex.build(JCfg(**KW), data["ref_ids"],
                                data["ref_lens"]),
                   JScfg(k=5, max_batch=8, mode="probe"))
    for r in rows:
        jeng.submit(r)
    ref = jeng.flush()
    with AsyncEngine(QueryEngine(index, SCFG), max_wait_ms=1.0) as eng:
        order = list(range(len(rows)))
        order = order[1::2] + order[0::2]
        futs = {j: eng.submit(rows[j]) for j in order}
        got = {j: f.result(timeout=T) for j, f in futs.items()}
    for j, ((wid, wd), (rid, rd)) in enumerate(zip(want, ref)):
        r = got[j]
        assert isinstance(r, Completed) and r.ok
        np.testing.assert_array_equal(r.ids, wid)
        np.testing.assert_array_equal(r.dists, wd)
        np.testing.assert_array_equal(r.ids, np.asarray(rid))
        np.testing.assert_array_equal(r.dists, np.asarray(rd))
        assert r.epoch == index.epoch


def test_async_singleton_vs_batch_composition(data, index):
    rows = _rows(data)
    with AsyncEngine(QueryEngine(index, SCFG), max_wait_ms=0.0,
                     start=False) as eng:
        solo = eng.submit(rows[0])
        eng._drain_once(timeout=0.01)           # batch of exactly 1
        futs = [eng.submit(r) for r in rows]    # batches of many
        while eng.pending():
            eng._drain_once(timeout=0.01)
        a = solo.result(timeout=T)
        b = futs[0].result(timeout=T)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)


# ------------------------------------------------------------ admission
def _shed_script(engine_cls, backend):
    """Three submits under a fake clock with a preset 50 ms cost for the
    rung a batch of 3 lands on; 20 ms of queueing, then one dispatch."""
    clock = FakeClock()
    eng = engine_cls(backend, max_wait_ms=0.0, clock=clock, start=False)
    eng._cost_ms[eng._rung(3)] = 50.0
    futs = [eng.submit(np.zeros(8, np.int8), deadline_ms=60.0),  # too late
            eng.submit(np.zeros(8, np.int8), deadline_ms=500.0),
            eng.submit(np.zeros(8, np.int8))]                    # none
    clock.advance(0.020)    # 20 ms queued: 20 + 50 predicted > 60
    eng._drain_once(timeout=0.0)
    out = [f.result(timeout=T) for f in futs]
    counters = eng.counters.snapshot()
    eng.close(timeout=T)
    return out, counters


def test_deadline_shedding_is_deterministic_and_the_references(data, index):
    out, counters = _shed_script(AsyncEngine, QueryEngine(index, SCFG))
    r = out[0]
    assert isinstance(r, Rejected) and r.reason == "deadline" and not r.ok
    assert r.predicted_ms == pytest.approx(50.0)
    assert r.queued_ms == pytest.approx(20.0)
    assert out[1].ok and out[2].ok
    assert counters["shed_deadline"] == 1 and counters["completed"] == 2
    # identical script, identical outcome (no hidden wall clock) — and the
    # reference's engine decides the same on the same script
    again, _ = _shed_script(AsyncEngine, QueryEngine(index, SCFG))
    ref, ref_counters = _shed_script(JAsync, _FakeBackend())
    for outs in (again, ref):
        assert [(o.ok, getattr(o, "reason", None)) for o in outs] == \
               [(o.ok, getattr(o, "reason", None)) for o in out]
        assert outs[0].queued_ms == pytest.approx(r.queued_ms)
        assert outs[0].predicted_ms == pytest.approx(r.predicted_ms)
    assert ref_counters == counters


def test_queue_full_and_shutdown_rejections(data, index):
    rows = _rows(data)
    eng = AsyncEngine(QueryEngine(index, SCFG), queue_depth=2, start=False)
    f1, f2 = eng.submit(rows[0]), eng.submit(rows[1])
    r3 = eng.submit(rows[2]).result(timeout=T)  # immediate: never blocks
    assert isinstance(r3, Rejected) and r3.reason == "queue_full"
    assert eng.counters["shed_queue_full"] == 1
    eng.close()                     # f1/f2 still queued -> shutdown
    assert f1.result(timeout=T).reason == "shutdown"
    assert f2.result(timeout=T).reason == "shutdown"
    assert eng.submit(rows[0]).result(timeout=T).reason == "shutdown"
    assert eng.counters["shed_shutdown"] == 3


def test_cost_model_rung_and_ewma_match_the_reference():
    engines = [cls(_FakeBackend(), start=False) for cls in (AsyncEngine,
                                                            JAsync)]
    for eng in engines:
        assert [eng._rung(b) for b in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
        assert eng.predicted_ms(3) == 0.0   # optimistic until measured
        eng._update_cost(3, 0.100)
        assert eng.predicted_ms(3) == pytest.approx(100.0)
        eng._update_cost(3, 0.200)          # EWMA, not overwrite
        assert eng.predicted_ms(3) == pytest.approx(
            COST_ALPHA * 200.0 + (1 - COST_ALPHA) * 100.0)
        assert eng.predicted_ms(8) == 0.0
        eng.close()
    assert engines[0]._cost_ms == engines[1]._cost_ms


# ------------------------------------------------------------ fleet races
def test_fleet_serving_during_refresh_and_compaction(data):
    """Queries racing a live ingest + compactions: every result equals a
    from-scratch build at the epoch it is tagged with, and nothing is
    rejected or torn."""
    n = len(data["ref_lens"])
    cut1, cut2 = n // 2, 3 * n // 4
    qids, qlens = data["query_ids"][:8], data["query_lens"][:8]
    expect = {}
    for epoch, upto in ((1, cut1), (2, cut2), (3, n)):
        idx = _build(data, upto)
        eng = QueryEngine(idx, SCFG, sharded=ShardedIndex(idx, ["cpu"] * 2))
        expect[epoch] = eng.query_batch(qids, qlens)

    live = _build(data, cut1)
    fleet = ReplicaFleet(live, SCFG, n_replicas=2, devices=["cpu"] * 2,
                         minor_compact_every=2)
    try:
        results, errors = [], []
        stop = threading.Event()

        def pound():
            try:
                while not stop.is_set():
                    nid, nd, epoch = fleet.query_batch(qids, qlens)
                    results.append((nid, nd, epoch))
            except Exception as e:        # noqa: BLE001 - reraised below
                errors.append(e)

        threads = [threading.Thread(target=pound) for _ in range(2)]
        for t in threads:
            t.start()
        ev1 = fleet.ingest(data["ref_ids"][cut1:cut2],
                           data["ref_lens"][cut1:cut2])
        assert ev1.wait(timeout=T) and ev1.ok
        ev2 = fleet.ingest(data["ref_ids"][cut2:], data["ref_lens"][cut2:])
        assert ev2.wait(timeout=T) and ev2.ok   # 2nd -> minor compaction
        nid, nd, epoch = fleet.query_batch(qids, qlens)
        assert epoch == 3
        stop.set()
        for t in threads:
            t.join(timeout=T)
            assert not t.is_alive()
        assert not errors, errors
        results.append((nid, nd, epoch))
        seen = set()
        for nid, nd, epoch in results:
            assert epoch in expect, f"torn epoch tag {epoch}"
            seen.add(epoch)
            np.testing.assert_array_equal(nid, expect[epoch][0])
            np.testing.assert_array_equal(nd, expect[epoch][1])
        assert 3 in seen
        assert fleet.counters["ingests"] == 2
        assert fleet.counters["minor_compactions"] == 1

        # major compaction racing queries: content (and answers) frozen
        threads = [threading.Thread(target=pound) for _ in range(2)]
        stop.clear()
        n_before = len(results)
        for t in threads:
            t.start()
        fleet.compact_index()
        stop.set()
        for t in threads:
            t.join(timeout=T)
            assert not t.is_alive()
        assert not errors, errors
        for nid, nd, _epoch in results[n_before:]:
            np.testing.assert_array_equal(nid, expect[3][0])
            np.testing.assert_array_equal(nd, expect[3][1])
        assert live.generation == 1 and live.epoch == 1
    finally:
        assert fleet.close(timeout=T)


def test_fleet_through_async_engine_bitexact(data):
    idx = _build(data)
    rows = _rows(data)
    sync = QueryEngine(idx, SCFG, sharded=ShardedIndex(idx))
    for r in rows:
        sync.submit(r)
    want = sync.flush()
    with ReplicaFleet(idx, SCFG, n_replicas=2) as fleet, \
            AsyncEngine(fleet, max_wait_ms=1.0) as eng:
        got = [eng.submit(r).result(timeout=T) for r in rows]
    for r, (wid, wd) in zip(got, want):
        assert r.ok and r.epoch == idx.epoch
        np.testing.assert_array_equal(r.ids, wid)
        np.testing.assert_array_equal(r.dists, wd)


def test_fleet_router_least_outstanding(index):
    with ReplicaFleet(index, SCFG, n_replicas=3, start_ingest=False) as fleet:
        picked = []
        for _ in range(3):
            rep = fleet._pick()
            picked.append(rep.name)
            with fleet._pick_lock:
                rep.last_used = fleet._ticket
            rep.lock.release()
        assert len(set(picked)) == 3        # idle: rotate by last_used
        busy = fleet._replicas[0]
        assert busy.lock.acquire(blocking=False)
        try:
            for _ in range(4):              # a busy replica is skipped
                rep = fleet._pick()
                assert rep.name != busy.name
                rep.lock.release()
        finally:
            busy.lock.release()
        assert fleet.counters["waited_busy"] == 0


def test_stats_surfaces(data, index):
    sync = QueryEngine(index, SCFG)
    sync.query_batch(data["query_ids"][:4], data["query_lens"][:4])
    s = sync.stats()
    assert set(s["stage_ms"]) == {"ladder", "sig", "probe", "rerank"}
    assert s["p99_ms"] >= s["p95_ms"] >= s["p50_ms"] >= 0
    rows = _rows(data)
    with AsyncEngine(QueryEngine(index, SCFG), max_wait_ms=0.5) as eng:
        [f.result(timeout=T) for f in (eng.submit(r) for r in rows[:4])]
        es = eng.stats()
    assert es["counters"]["completed"] == 4
    assert es["latency"]["count"] == 4 and es["cost_model_ms"]
    assert es["backend"]["n_queries"] >= 4 and es["dispatch"]["alive"]
    with ReplicaFleet(index, SCFG, n_replicas=2,
                      start_ingest=False) as fleet:
        fleet.query_batch(data["query_ids"][:4], data["query_lens"][:4])
        fs = fleet.stats()
    assert fs["n_replicas"] == 2 and len(fs["replicas"]) == 2
    assert all(r["epoch"] == (index.epoch, index.epoch)
               for r in fs["replicas"])
    assert fs["counters"]["batches"] == 1


# ------------------------------------------------------------ supervisor
def test_supervisor_restarts_then_recovers():
    crashes, delays = [], []
    state = {"n": 0}

    def run_once():
        state["n"] += 1
        if state["n"] <= 3:
            raise RuntimeError(f"boom {state['n']}")
        return 1

    sup = Supervisor("t", run_once, on_crash=crashes.append,
                     max_consecutive_failures=5, sleep=delays.append,
                     idle_sleep_s=0.001).start()
    _wait_until(lambda: sup.crashes >= 3 and sup.consecutive == 0,
                "supervisor never recovered")
    assert sup.stop(timeout=T)
    s = sup.stats()
    assert s["crashes"] == 3 and s["consecutive_failures"] == 0
    assert not s["degraded"] and "boom 3" in s["last_error"]
    assert len(crashes) == 3 and len([d for d in delays if d > 0]) >= 3


def test_supervisor_gives_up_visibly():
    gave_up = []
    sup = Supervisor("t", lambda: (_ for _ in ()).throw(RuntimeError("x")),
                     on_giveup=gave_up.append,
                     max_consecutive_failures=3, sleep=lambda s: None).start()
    _wait_until(lambda: sup.degraded, "supervisor never gave up")
    sup._thread.join(timeout=T)
    s = sup.stats()
    assert s["degraded"] and not s["alive"] and s["crashes"] == 3
    assert len(gave_up) == 1


def test_supervisor_backoff_is_seeded_capped_and_the_references():
    kw = dict(seed=42, backoff_base_s=0.01, backoff_cap_s=0.08)
    seqs = [[sup.backoff_s(n) for n in range(1, 8)]
            for sup in (Supervisor("a", lambda: 0, **kw),
                        Supervisor("b", lambda: 0, **kw),
                        JSupervisor("c", lambda: 0, **kw))]
    assert seqs[0] == seqs[1] == seqs[2]    # same seed -> same jitter
    assert all(d <= 0.08 * 1.5 for d in seqs[0])
    assert seqs[0][0] < seqs[0][2]


# ------------------------------------------------------------ engine faults
def test_engine_internal_failure_resolves_futures_typed():
    eng = AsyncEngine(_FakeBackend(fail_first=99), start=False)
    f1 = eng.submit(np.zeros(8, np.int8))
    f2 = eng.submit(np.zeros(8, np.int8))
    with pytest.raises(RuntimeError):       # the crash still propagates
        eng._drain_once(timeout=0.01)
    r1, r2 = f1.result(timeout=T), f2.result(timeout=T)
    assert isinstance(r1, Rejected) and r1.reason == "internal"
    assert "backend down" in r1.detail and r2.reason == "internal"
    assert eng.counters["shed_internal"] == 2


def test_engine_supervised_dispatch_restarts_with_the_references_ledger():
    """A scripted dispatch crash: the batch resolves internal, the loop
    restarts and serves; the port's and the reference's plans record the
    same ledger for the same call sequence."""
    ledgers = []
    for plan_cls, fp, eng_cls in ((FaultPlan, fault_point, AsyncEngine),
                                  (JPlan, j_fault_point, JAsync)):
        eng = eng_cls(_FakeBackend(), max_wait_ms=0.0)
        try:
            with plan_cls().add("engine.dispatch", "raise", on=1) as plan:
                r1 = eng.submit(np.zeros(8, np.int8)).result(timeout=T)
                r2 = eng.submit(np.zeros(8, np.int8)).result(timeout=T)
            assert r1.reason == "internal" and "injected" in r1.detail
            assert r2.ok and r2.epoch == 7
            d = eng.stats()["dispatch"]
            assert d["crashes"] == 1 and d["alive"] and not d["degraded"]
            ledgers.append(plan.ledger())
        finally:
            assert eng.close(timeout=T)
    assert ledgers[0] == ledgers[1] == [("engine.dispatch", 1, "raise")]


def test_engine_dispatch_giveup_drains_queue_and_sheds_new():
    eng = AsyncEngine(_FakeBackend(fail_first=10 ** 9), max_wait_ms=0.0)
    try:
        futs = [eng.submit(np.zeros(8, np.int8)) for _ in range(4)]
        deadline = time.monotonic() + T
        while not eng._sup.degraded:
            futs.append(eng.submit(np.zeros(8, np.int8)))  # keep it fed
            assert time.monotonic() < deadline, eng.stats()["dispatch"]
            time.sleep(0.01)
        outs = [f.result(timeout=T) for f in futs]
        assert all(o.reason == "internal" for o in outs)    # none stranded
        late = eng.submit(np.zeros(8, np.int8)).result(timeout=T)
        assert late.reason == "internal" and "degraded" in late.detail
    finally:
        eng.close(timeout=T)


def test_engine_close_reports_wedged_thread():
    gate = threading.Event()
    eng = AsyncEngine(_FakeBackend(block_on=gate), max_wait_ms=0.0)
    eng.submit(np.zeros(8, np.int8))
    _wait_until(lambda: eng.pending() == 0, "dispatch never took the batch")
    time.sleep(0.05)                        # let dispatch enter the backend
    assert eng.close(timeout=0.2) is False  # wedged: REPORTED, not hidden
    assert eng.stats()["wedged"]
    gate.set()                              # release the stuck thread
    eng._sup._thread.join(timeout=T)
    assert not eng._sup.alive


# ------------------------------------------------------------ fleet health
def test_fleet_chaos_script_retries_with_the_references_ledger(data, index):
    """The serving CLI's chaos script (raise at replica.query calls 2 and
    5, latency at 6) through AsyncEngine over a 2-replica fleet: 2 router
    retries, 0 degraded, every answer the fault-free one; the reference's
    plan gives the same ledger over the same call sequence."""
    rows = _rows(data)[:12]
    sync = QueryEngine(index, SCFG, sharded=ShardedIndex(index))
    for r in rows:
        sync.submit(r)
    want = sync.flush()
    script = (("replica.query", "raise", dict(on=2)),
              ("replica.query", "raise", dict(on=5)),
              ("replica.query", "latency", dict(on=6, delay_s=0.01)))
    plan = FaultPlan()
    for site, kind, kw in script:
        plan.add(site, kind, **kw)
    with ReplicaFleet(index, SCFG, n_replicas=2,
                      start_ingest=False) as fleet, \
            AsyncEngine(fleet, max_wait_ms=0.0, start=False) as eng:
        with plan:
            futs = []
            for r in rows:                  # one query per dispatch
                futs.append(eng.submit(r))
                eng._drain_once(timeout=0.01)
        got = [f.result(timeout=T) for f in futs]
        c = fleet.counters
        assert (c["retries"], c["retry_success"]) == (2, 2)
        assert c["degraded_batches"] == 0 and fleet.coverage() == 1.0
    for r, (wid, wd) in zip(got, want):
        assert isinstance(r, Completed)
        np.testing.assert_array_equal(r.ids, wid)
        np.testing.assert_array_equal(r.dists, wd)
    jplan = JPlan(sleep=lambda s: None)
    for site, kind, kw in script:
        jplan.add(site, kind, **kw)
    with jplan:
        for _ in range(plan.calls("replica.query")):
            try:
                j_fault_point("replica.query")
            except Exception:               # noqa: BLE001 - the script's
                pass
    assert plan.ledger() == jplan.ledger() == [
        ("replica.query", 2, "raise"), ("replica.query", 5, "raise"),
        ("replica.query", 6, "latency")]
    assert plan.unfired() == []


def test_fleet_retries_failed_batch_on_other_replica(data, index):
    fleet = ReplicaFleet(index, SCFG, n_replicas=2, start_ingest=False)
    q, ql = data["query_ids"][:4], data["query_lens"][:4]
    want = ReplicaFleet(index, SCFG, n_replicas=1,
                        start_ingest=False).query_batch(q, ql)
    with FaultPlan().add("replica.query", "raise", on=1):
        nid, nd, epoch = fleet.query_batch(q, ql)
    np.testing.assert_array_equal(nid, want[0])
    np.testing.assert_array_equal(nd, want[1])
    assert epoch == want[2]
    c = fleet.counters
    assert (c["retries"], c["retry_success"]) == (1, 1)
    assert c["replica_failures"] == 1 and c["replica_quarantines"] == 0
    assert fleet.coverage() == 1.0


def test_fleet_quarantine_halfopen_probe_readmission(data, index):
    clock = FakeClock()
    fleet = ReplicaFleet(index, SCFG, n_replicas=2, start_ingest=False,
                         fail_threshold=1, quarantine_s=10.0, clock=clock)
    q, ql = data["query_ids"][:2], data["query_lens"][:2]
    with FaultPlan().add("replica.query", "raise", on={1, 2}) as plan:
        out = fleet.query_batch(q, ql)      # both replicas fail -> degraded
        assert isinstance(out, DegradedBatch) and out.coverage == 0.0
        assert (out.ids == -1).all() and np.isinf(out.dists).all()
        assert out.epoch is None and "injected" in out.detail
        out2 = fleet.query_batch(q, ql)     # still quarantined: no attempt
        assert isinstance(out2, DegradedBatch)
        assert plan.calls("replica.query") == 2
        clock.advance(10.5)                 # quarantine expires
        fleet.query_batch(q, ql)            # half-open probe #1
        fleet.query_batch(q, ql)            # half-open probe #2
    c = fleet.counters
    assert c["replica_quarantines"] == 2 and c["degraded_batches"] == 2
    assert c["replica_probes"] == 2 and c["replica_readmissions"] == 2
    assert fleet.coverage() == 1.0
    health = [r["health"] for r in fleet.stats()["replicas"]]
    assert all(not h["quarantined"] and h["fails"] == 0 for h in health)


def test_fleet_degraded_flows_through_engine_typed(data, index):
    fleet = ReplicaFleet(index, SCFG, n_replicas=2, start_ingest=False,
                         fail_threshold=1, quarantine_s=60.0,
                         clock=FakeClock())
    eng = AsyncEngine(fleet, start=False)
    with FaultPlan().add("replica.query", "raise", on={1, 2}):
        fut = eng.submit(_rows(data)[0])
        eng._drain_once(timeout=0.01)
    out = fut.result(timeout=T)
    assert isinstance(out, Degraded) and not out.ok and out.degraded
    assert out.coverage == 0.0 and out.epoch is None
    assert eng.counters["degraded"] == 1


def test_fleet_ingest_crash_resolves_ticket_and_restarts(data):
    index = _build(data)                # this test MUTATES its index
    index._ensure_built()
    epoch0 = index.epoch
    fleet = ReplicaFleet(index, SCFG, n_replicas=2)
    try:
        with FaultPlan().add("ingest.apply", "kill", on=1):
            t1 = fleet.ingest(data["ref_ids"][:4], data["ref_lens"][:4])
            assert t1.wait(timeout=T)       # resolved, not stranded
            assert not t1.ok and "injected" in t1.error
            t2 = fleet.ingest(data["ref_ids"][:4], data["ref_lens"][:4])
            assert t2.wait(timeout=T) and t2.ok and t2.error is None
        st = fleet.stats()
        assert st["counters"]["ingest_failures"] == 1
        assert st["counters"]["ingests"] == 1
        assert st["ingest"]["crashes"] == 1 and st["ingest"]["alive"]
        assert not st["ingest"]["degraded"]
        assert index.epoch == epoch0 + 1
        assert all(r["epoch"] == (epoch0, epoch0 + 1)
                   for r in st["replicas"])
    finally:
        assert fleet.close(timeout=T)


def test_fleet_close_resolves_queued_tickets(data):
    index = _build(data)
    fleet = ReplicaFleet(index, SCFG, n_replicas=1, start_ingest=False)
    t = fleet.ingest(data["ref_ids"][:4], data["ref_lens"][:4])
    assert fleet.close(timeout=T)
    assert t.is_set() and not t.ok and "Shutdown" in t.error


# ------------------------------------------------------------ observability
def test_rolling_window_and_counters_match_the_reference():
    ours, ref = Rolling(window=4), JRolling(window=4)
    for ms in (10, 20, 30, 40, 50, 60):     # first two leave the window
        ours.add(ms / 1e3)
        ref.add(ms / 1e3)
    snap = ours.snapshot()
    assert snap == ref.snapshot()
    assert snap["count"] == 4 and snap["total"] == 6
    assert snap["p50_ms"] == pytest.approx(45.0)
    c = Counters("a")
    c.bump("a")
    with pytest.warns(UserWarning, match="undeclared"):
        c.bump("b", by=2)
    assert c["a"] == 1 and c["b"] == 2 and c["missing"] == 0
    assert c.snapshot() == {"a": 1, "b": 2}


def _observe(reg):
    """One script of declarations and observations for either registry."""
    h = reg.histogram("serve_seconds", "batch wall-clock",
                      labelnames=("engine",))
    for i, v in enumerate((1e-5, 3e-4, 0.002, 0.002, 0.5, 400.0)):
        h.observe(v, engine=f"e{i % 2}")
    reg.counter("requests", "requests by outcome",
                labelnames=("outcome",)).inc(3, outcome="completed")
    reg.counter("requests", "requests by outcome",
                labelnames=("outcome",)).inc(outcome="shed_deadline")
    reg.gauge("queue_depth", "queued requests").set(7)
    reg.counter("plain", "no labels").inc(2)
    return reg


def test_prometheus_text_and_snapshot_equal_the_references():
    ours, ref = _observe(Registry()), _observe(JRegistry())
    assert ours.prometheus() == ref.prometheus()
    assert ours.snapshot() == ref.snapshot()
    m_ours = ours.families()["serve_seconds"].merged()
    m_ref = ref.families()["serve_seconds"].merged()
    assert m_ours.state() == m_ref.state() and m_ours.count == 6
    with pytest.raises(ValueError, match="redeclaration"):
        ours.gauge("requests")
    with pytest.raises(ValueError, match="bounds differ"):
        ours.histogram("serve_seconds", labelnames=("engine",),
                       bounds=(1.0, 2.0))


def test_histogram_merge_state_roundtrip_match_the_reference():
    a, b = Histogram(), Histogram()
    ja, jb = JHist(), JHist()
    for v in (1e-4, 2e-3, 2e-3):
        a.observe(v)
        ja.observe(v)
    for v in (0.3, 7.0):
        b.observe(v)
        jb.observe(v)
    a.merge(b)
    ja.merge(jb)
    assert a.state() == ja.state() and len(a) == 5
    assert a.snapshot() == ja.snapshot()
    back = Histogram.from_state(a.state())
    assert back.state() == a.state() and back.quantile(0.5) == a.quantile(0.5)
    with pytest.raises(ValueError, match="bounds differ"):
        a.merge(Histogram((1.0, 2.0)))


def test_tracer_trace_ids_and_chrome_export(tmp_path):
    """Spans recorded under a trace context carry its IDs; the Chrome
    export has the reference's shape (metadata, complete and instant
    events); the buffer is bounded and counts what it dropped."""
    outs = []
    for tracer in (Tracer(capacity=4), JTracer(capacity=4)):
        tracer.enable()
        tid = new_trace_id()
        with trace_context((tid, tid + 1)):
            assert current_trace() == (tid, tid + 1)
            tracer.record("probe", "serve", 1.0, 1.5, {"cap": 8})
        tracer.record("submit", "serve", 2.0, None, {"trace": [tid]})
        for i in range(4):
            tracer.record(f"s{i}", "lifecycle", 3.0, 3.1)
        assert len(tracer) == 4
        outs.append(tracer.chrome_trace())
    ours, ref = outs
    assert ours["otherData"] == ref["otherData"] == {"dropped_spans": 2}
    strip = [[{k: v for k, v in e.items() if k not in ("ts", "tid", "pid",
                                                       "dur")}
              for e in o["traceEvents"]] for o in outs]
    assert strip[0][1:] == strip[1][1:]     # metadata names the thread
    t = Tracer()
    t.enable()
    with trace_context((5,)):
        t.record("rerank", "serve", 1.0, 2.0)
    assert t.spans()[0]["args"] == {"trace": [5]}
    n = t.export(tmp_path / "trace.json")
    assert n == 2 and (tmp_path / "trace.json").stat().st_size > 0
    t.clear()
    assert len(t) == 0
