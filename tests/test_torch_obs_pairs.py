"""The pair dump traced from inside the port: ``QueryEngine.search_pairs``'
always-on job log (``pair_stats()``: host stamps, join attempts, bytes
uploaded onto a card, device spans), its spans (``search_pairs`` around
``pairs.job1`` and one ``pairs.join`` an attempt, one trace id a job), and
the tracer on the profiler's clock.

Everything here runs on the CPU except the two ``cuda``-marked tests,
which skip without a card and hold the card's readings to three promises:
the upload counter counts each read set's bytes twice, each device span is
positive, and reading them adds no synchronizing call, in the flip job and
in the dense join's count and emission stages. The file imports no jax,
so on a machine with the card:

    python -m pytest -q -m cuda tests/test_torch_obs_pairs.py
"""
import json
import math
import time
import warnings
from collections import deque

import numpy as np
import pytest
import torch

from repro_torch.core.pipeline import LSHConfig
from repro_torch.data.synthetic import SyntheticProteinConfig, \
    make_protein_sets
from repro_torch.index import service
from repro_torch.index.service import QueryEngine, ServingConfig
from repro_torch.index.store import SignatureIndex
from repro_torch.obs.trace import TRACER, Tracer, span

CFG = LSHConfig(k=3, T=13, f=32, d=1, scheme="java", max_pairs=1 << 14)


@pytest.fixture(scope="module")
def data():
    return make_protein_sets(SyntheticProteinConfig(
        n_refs=96, n_homolog_queries=24, n_decoy_queries=24,
        ref_len_mean=100, ref_len_std=15, sub_rates=(0.03, 0.1), seed=17))


def _engine(data, device="cpu"):
    index = SignatureIndex.build(CFG, data["ref_ids"], data["ref_lens"],
                                 layout="flip", device=device)
    return QueryEngine(index, ServingConfig(k=3))


@pytest.fixture
def tracer_off():
    """The process-wide tracer, off and empty before and after."""
    TRACER.disable()
    TRACER.clear()
    yield TRACER
    TRACER.disable()
    TRACER.clear()


def _count_calls(engine, name):
    """Wrap the engine pipeline's method ``name`` on the instance; returns
    the list its calls append to."""
    calls = []
    orig = getattr(engine.sl, name)

    def run(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    setattr(engine.sl, name, run)
    return calls


def test_pair_stats_count_a_grown_job(data):
    """From a capacity of 2 the join doubles until nothing overflows: one
    attempt a capacity. A CPU pipeline moves no bytes onto a card and has
    no device spans."""
    eng = _engine(data)
    searches = _count_calls(eng, "search")
    res = eng.search_pairs(data["query_ids"], data["query_lens"],
                           max_pairs=2)
    assert not bool(res.overflowed)
    cap = res.pairs.shape[0]
    attempts = int(math.log2(cap // 2)) + 1        # 2, 4, ..., cap
    assert attempts > 1 and len(searches) == attempts
    [job] = eng.pair_stats()
    assert {k: job[k] for k in ("attempts", "h2d_bytes", "job1_dev_s",
                                "join_dev_s")} == dict(
        attempts=attempts, h2d_bytes=0, job1_dev_s=None, join_dev_s=None)
    assert job["t0"] < job["t1"]
    assert eng.sl.h2d_bytes == 0


@pytest.mark.parametrize("method", ["flip", "band", "dense"])
def test_pair_log_is_the_same_for_every_join_method(data, method):
    cfg = LSHConfig(k=3, T=13, f=32, d=1, scheme="java", join_method=method,
                    max_pairs=1 << 14)
    index = SignatureIndex.build(cfg, data["ref_ids"], data["ref_lens"],
                                 device="cpu")
    eng = QueryEngine(index, ServingConfig(k=3))
    searches = _count_calls(eng, "search")
    eng.search_pairs(data["query_ids"], data["query_lens"])
    [job] = eng.pair_stats()
    assert set(job) == {"t0", "t1", "attempts", "h2d_bytes", "job1_dev_s",
                        "join_dev_s", "count_dev_s", "emit_dev_s",
                        "emit_tiles", "emit_rows"}
    assert job["attempts"] == len(searches) == 1


def test_search_pairs_records_nothing_with_the_tracer_off(data, tracer_off):
    eng = _engine(data)
    eng.search_pairs(data["query_ids"], data["query_lens"], max_pairs=4)
    assert len(TRACER) == 0
    assert len(eng.pair_stats()) == 1         # the log is always on


def test_search_pairs_spans_nest_and_share_a_trace(data, tracer_off):
    eng = _engine(data)
    TRACER.enable()
    for _ in range(2):
        eng.search_pairs(data["query_ids"], data["query_lens"], max_pairs=2)
    TRACER.disable()
    spans = TRACER.spans()
    roots = [s for s in spans if s["name"] == "search_pairs"]
    assert len(roots) == 2
    traces = [r["args"]["trace"] for r in roots]
    assert traces[0] != traces[1] and all(len(t) == 1 for t in traces)
    for root, job in zip(roots, eng.pair_stats()):
        kids = [s for s in spans if s["name"] in ("pairs.job1", "pairs.join")
                and s["args"]["trace"] == root["args"]["trace"]]
        joins = [s for s in kids if s["name"] == "pairs.join"]
        assert [s["name"] for s in kids].count("pairs.job1") == 1
        assert len(joins) == job["attempts"] == root["args"]["attempts"]
        assert root["args"]["reads"] == len(data["query_lens"])
        assert root["args"]["capacity"] == joins[-1]["args"]["capacity"]
        assert root["args"]["dev_ms"] is None       # no card
        for s in kids:      # inside the root, on the host's clock
            assert s["ts"] >= root["ts"] - 1e-6
            assert s["ts"] + s["dur"] <= root["ts"] + root["dur"] + 1e-6
        a = [j["args"] for j in joins]
        assert [x["attempt"] for x in a] == list(range(len(a)))
        assert [x["capacity"] for x in a] == [2 << i for i in range(len(a))]
        assert [x["overflowed"] for x in a] == [True] * (len(a) - 1) + [False]


def test_job_log_stays_bounded_and_reset_empties_it(data):
    eng = _engine(data)
    eng._pair_log = deque(maxlen=3)
    ids, lens = data["query_ids"][:8], data["query_lens"][:8]
    stamps = []
    for _ in range(5):
        eng.search_pairs(ids, lens)
        stamps.append(eng.pair_stats()[-1]["t0"])
    log = eng.pair_stats()
    assert [j["t0"] for j in log] == stamps[2:]     # the newest, in order
    assert service.PAIR_LOG_JOBS >= 1000            # a window's jobs, many
    eng.reset_stats()
    assert eng.pair_stats() == []


def test_span_lies_on_the_profilers_timeline(tmp_path, tracer_off):
    """A span exported beside a torch profiler trace brackets an aten op
    run inside it, to within 1 ms on the profiler's timeline; ``spans()``
    is on the wall clock."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(384, 384)
    TRACER.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", cat="test"):
            time.sleep(0.003)
            t_op = time.perf_counter()
            for _ in range(4):
                x = torch.mm(x, x).clamp_(-1, 1)
            time.sleep(0.003)
    TRACER.disable()
    prof_path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(prof_path))
    merged = tmp_path / "merged.json"
    TRACER.export(merged, merge=prof_path)
    events = json.loads(merged.read_text())["traceEvents"]
    [outer] = [e for e in events if e.get("name") == "outer"]
    mms = [e for e in events if e.get("name") == "aten::mm"]
    assert len(mms) == 4
    first = min(e["ts"] for e in mms)
    last = max(e["ts"] + e["dur"] for e in mms)
    assert outer["ts"] <= first + 1e3
    assert last <= outer["ts"] + outer["dur"] + 1e3
    # and no looser than the host's own stamps say: the ops start where
    # t_op, taken just before them, lies within the span
    [sp] = TRACER.spans()
    span_start = sp["ts"] - time.time() + time.perf_counter()   # as perf
    lead_us = (t_op - span_start) * 1e6
    assert abs((first - outer["ts"]) - lead_us) < 1e3
    assert abs(sp["ts"] - time.time()) < 60


def test_clear_keeps_the_epoch():
    t = Tracer()
    t.enable()
    stamp = time.perf_counter()
    t.record("a", "test", stamp, stamp + 0.001)
    before = t.spans()[0]["ts"], t.chrome_trace()["traceEvents"][-1]["ts"]
    t.clear()
    t.record("a", "test", stamp, stamp + 0.001)
    after = t.spans()[0]["ts"], t.chrome_trace()["traceEvents"][-1]["ts"]
    assert before == after
    base = 1_700_000_000 * 10**9
    shifted = t.chrome_trace(base)["traceEvents"][-1]["ts"]
    assert shifted == pytest.approx(after[1] - base / 1e3, abs=1.0)


def _bare_search_pairs(engine, q_ids, q_lens, max_pairs):
    """``search_pairs`` with its instrumentation taken out: the loop as it
    stood before the job log and the spans."""
    sl = engine.sl
    q_sigs = sl.signatures(q_ids, q_lens)
    q_valid = sl.feature_counts(q_ids, q_lens) > 0
    mp = max_pairs
    while True:
        res = sl.search(q_sigs, engine.index.device_sigs, max_pairs=mp,
                        q_valid=q_valid, r_valid=engine.index.device_valid)
        if not bool(res.overflowed) or mp >= 1 << 22:
            return res
        mp = min(mp * 2, 1 << 22)


def _sync_warnings(fn) -> int:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.cuda
def test_device_spans_add_no_sync_on_card(data):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device spans are CUDA events")
    eng = _engine(data, device="cuda")
    ids, lens = data["query_ids"], data["query_lens"]
    for _ in range(2):      # warm both paths: lazy uploads, allocations
        eng.search_pairs(ids, lens, max_pairs=2)
        _bare_search_pairs(eng, ids, lens, 2)
    torch.cuda.synchronize()
    eng.reset_stats()
    bare = _sync_warnings(lambda: _bare_search_pairs(eng, ids, lens, 2))
    traced = _sync_warnings(lambda: eng.search_pairs(ids, lens, max_pairs=2))
    assert bare > 0 and traced <= bare
    eng.search_pairs(ids, lens, max_pairs=2)
    log = eng.pair_stats()
    # job 1 takes the numpy reads up twice: signatures and feature counts
    upload = 2 * (np.asarray(ids, np.int8).nbytes
                  + np.asarray(lens, np.int32).nbytes)
    assert len(log) == 2
    for job in log:
        assert job["h2d_bytes"] == upload
        assert job["job1_dev_s"] > 0
        assert len(job["join_dev_s"]) == job["attempts"] > 1
        assert all(s > 0 for s in job["join_dev_s"])


@pytest.mark.cuda
def test_dense_stage_spans_add_no_sync_on_card(data):
    """The dense join's count and emission marks at d = 3, from a capacity
    of 4: no more host syncs than the loop without them, the same dump,
    and positive stage spans inside each attempt's join span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device spans are CUDA events")
    cfg = LSHConfig(k=3, T=13, f=32, d=3, scheme="java", join_method="dense",
                    max_pairs=1 << 14)
    eng = QueryEngine(SignatureIndex.build(cfg, data["ref_ids"],
                                           data["ref_lens"], device="cuda"),
                      ServingConfig(k=3))
    ids, lens = data["query_ids"], data["query_lens"]
    for _ in range(2):      # warm both paths: lazy uploads, allocations
        eng.search_pairs(ids, lens, max_pairs=4)
        _bare_search_pairs(eng, ids, lens, 4)
    torch.cuda.synchronize()
    eng.reset_stats()
    bare = _sync_warnings(lambda: _bare_search_pairs(eng, ids, lens, 4))
    traced = _sync_warnings(lambda: eng.search_pairs(ids, lens, max_pairs=4))
    assert bare > 0 and traced <= bare
    got = eng.search_pairs(ids, lens, max_pairs=4)
    want = _bare_search_pairs(eng, ids, lens, 4)
    np.testing.assert_array_equal(got.pairs.cpu().numpy(),
                                  want.pairs.cpu().numpy())
    assert (int(got.count), bool(got.overflowed)) == \
        (int(want.count), bool(want.overflowed))
    for job in eng.pair_stats():
        n = job["attempts"]
        assert n > 1 and job["emit_tiles"] >= n
        assert len(job["count_dev_s"]) == len(job["emit_dev_s"]) == n
        for c, e, j in zip(job["count_dev_s"], job["emit_dev_s"],
                           job["join_dev_s"]):
            assert 0 < c and 0 < e and c + e <= j
