"""The readers of the dense pair dump (``dense.*``, the ``k6_count`` and
``k2_emit`` roofline shares) and their yardstick (``bench/roofline_hamming.py``): they read the program's job log
over the window's jobs, the roofline shares the profiled stretch's jobs
and kernels, and nothing without a card's trace or for an index that is
not dense-joined."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench import harness, roofline_hamming
from bench.tests.docs import bench_doc

SEED = 2**31 + 977
SMALL = {"config.refs.n": 3000, "traffic.queries.n": 600,
         "traffic.n_sets": 2, "traffic.warmup_calls": 1}
LOG_READERS = ("dense.count_dev_ms", "dense.emit_dev_ms", "dense.emit_tiles")
READERS = LOG_READERS + ("k6_count.roofline_pct", "k2_emit.roofline_pct")
CELLS = {"swissprot-pairdump-dense.reads-d1"}
# the pair dump's readers that the dense cell is listed for as well
SHARED = ("pairdump.job1_ms", "pairdump.join_ms", "pairdump.join_attempts",
          "device_idle_pct.pairdump")
CLOCK = 1.98e9              # the H100's maximum SM clock, nvidia-smi's
R, READS = 454_401, 547_169
# the profiler's names of the kernels, K6 and K2 beside job 1's counts
K6_NAME = "void (anonymous namespace)::count_kernel<1>(unsigned int const*)"
K2_NAME = "void (anonymous namespace)::dist_kernel<1>(unsigned int const*)"
TABLE_COUNTS = "(anonymous namespace)::counts_kernel(signed char const*)"


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def _job(t0, t1, **kw):
    job = dict(t0=t0, t1=t1, attempts=2, h2d_bytes=3_000_000,
               job1_dev_s=0.010, join_dev_s=(0.070, 0.080),
               count_dev_s=(0.065, 0.066), emit_dev_s=(0.004, 0.012),
               emit_tiles=30, emit_rows=8_000)
    job.update(kw)
    return job


def _records(*spans, n=READS):
    return [harness.Record(SimpleNamespace(n=n), object(), a, b)
            for a, b in spans]


def _card(*ops, busy=0.9, window=1.0):
    """A device summary's stand-in: ops as (name, start us, end us)."""
    return SimpleNamespace(busy_s=busy, window_s=window, ops=list(ops))


def _ctx(log, records, *, device=None, method="dense", profiled=()):
    index = SimpleNamespace(size=R, cfg=SimpleNamespace(
        join_method=method, f=32, d=3))
    engine = SimpleNamespace(pair_stats=lambda: list(log), index=index)
    return SimpleNamespace(
        device=_card() if device is None else device, records=records,
        profiled=list(profiled), driver=SimpleNamespace(engine=engine))


@pytest.fixture
def clock(monkeypatch):
    monkeypatch.setattr(roofline_hamming, "sm_clock_hz", lambda: CLOCK)


def test_roofline_functions_on_perfs_shapes():
    """K6 over the whole read set at one word is popcount-bound at 59.457
    ms (PERF.md's K6 row); K2 over one 295-row emission tile is bound by
    its bytes, 0.1606 ms (its emission-tile row)."""
    t, by = roofline_hamming.hamming_count_bound_s(READS, R, 1, CLOCK)
    assert by == "operations" and t * 1e3 == pytest.approx(59.457, abs=5e-4)
    t, by = roofline_hamming.hamming_dist_bound_s(295, R, 1)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.1606, abs=5e-5)
    # tiles summed: their bytes add, the references read once a tile
    two, _ = roofline_hamming.hamming_dist_bound_s(590, R, 1, calls=2)
    assert two == pytest.approx(2 * t)
    # bytes up to 26 words at any rows, operations well past it
    assert roofline_hamming.hamming_dist_bound_s(10**6, R, 26)[1] == "bytes"
    assert roofline_hamming.hamming_dist_bound_s(295, R, 40)[1] == \
        "operations"


def test_log_readers_pick_only_the_windows_jobs():
    far = dict(attempts=9, count_dev_s=(9.0,), emit_dev_s=(9.0,),
               emit_tiles=900, emit_rows=9)
    log = [_job(0.0, 1.0, **far), _job(10.0, 11.0),
           _job(11.0, 12.0, attempts=1, count_dev_s=(0.064,),
                emit_dev_s=(0.020,), emit_tiles=10, emit_rows=2_000),
           _job(13.0, 14.0, **far)]
    ctx = _ctx(log, _records((10.0, 11.0), (11.0, 12.0)),
               profiled=_records((13.0, 14.0)))
    got = {n: _read(n, ctx) for n in LOG_READERS}
    assert got == pytest.approx({"dense.count_dev_ms": 97.5,   # 131, 64 ms
                                 "dense.emit_dev_ms": 18.0,    # 16, 20 ms
                                 "dense.emit_tiles": 20.0})


def test_roofline_readers_read_the_profiled_jobs(clock):
    """Two profiled jobs; K6's time is the count kernels' alone (not job
    1's ``counts_kernel``), K2's the distance kernels'."""
    log = [_job(10.0, 11.0), _job(13.0, 14.0),
           _job(14.0, 15.0, attempts=3, emit_tiles=40, emit_rows=9_000)]
    k6_us, k2_us = 300_000.0, 20_000.0
    dev = _card((K6_NAME, 0.0, k6_us / 2), (K6_NAME, 1e6, 1e6 + k6_us / 2),
                (TABLE_COUNTS, 2e6, 2e6 + 1e5), (K2_NAME, 3e6, 3e6 + k2_us))
    ctx = _ctx(log, _records((10.0, 11.0)), device=dev,
               profiled=_records((13.0, 14.0), (14.0, 15.0)))
    k6_bound = 5 * roofline_hamming.hamming_count_bound_s(
        READS, R, 1, CLOCK)[0]
    k2_bound = roofline_hamming.hamming_dist_bound_s(17_000, R, 1, 70)[0]
    assert _read("k6_count.roofline_pct", ctx) == pytest.approx(
        100 * k6_bound / (k6_us / 1e6))
    assert _read("k2_emit.roofline_pct", ctx) == pytest.approx(
        100 * k2_bound / (k2_us / 1e6))


@pytest.mark.parametrize("case", ["no_card_trace", "flip_index", "no_log",
                                  "short_log", "the_parents_log"])
def test_readers_read_nothing_where_they_cannot(case, clock):
    log = [_job(10.0, 11.0), _job(11.0, 12.0), _job(13.0, 14.0)]
    dev = _card((K6_NAME, 0.0, 1e5), (K2_NAME, 2e5, 3e5))
    kw = dict(device=dev, profiled=_records((13.0, 14.0)))
    records = _records((10.0, 11.0), (11.0, 12.0))
    if case == "no_card_trace":
        ctx = _ctx(log, records, **kw)
        ctx.device = None
    elif case == "flip_index":     # the flip join logs no dense fields
        log = [_job(a, b, **dict.fromkeys(
            ("count_dev_s", "emit_dev_s", "emit_tiles", "emit_rows")))
            for a, b in ((10.0, 11.0), (11.0, 12.0), (13.0, 14.0))]
        ctx = _ctx(log, records, method="flip", device=_card(), profiled=())
    elif case == "no_log":          # a program without pair_stats
        ctx = _ctx(log, records, **kw)
        del ctx.driver.engine.pair_stats
    elif case == "short_log":       # the bounded log lost the jobs
        ctx = _ctx(log[2:], records, device=dev, profiled=_records(
            (16.0, 17.0)))
    else:                           # no dense fields: a program before them
        keep = ("t0", "t1", "attempts", "h2d_bytes", "job1_dev_s",
                "join_dev_s")
        ctx = _ctx([{k: j[k] for k in keep} for j in log], records, **kw)
    got = {n: _read(n, ctx) for n in READERS}
    if case == "the_parents_log":   # the attempts and K6's time are there
        assert got.pop("k6_count.roofline_pct") > 0
    assert got == dict.fromkeys(got)


def test_k6_share_without_the_cards_clock_reads_nothing(monkeypatch):
    monkeypatch.setattr(roofline_hamming, "sm_clock_hz", lambda: None)
    ctx = _ctx([_job(13.0, 14.0)], [], device=_card((K6_NAME, 0.0, 1e5)),
               profiled=_records((13.0, 14.0)))
    assert _read("k6_count.roofline_pct", ctx) is None


def test_readers_of_a_real_window_on_the_cpu():
    """A short window of the dense cell's driver on the CPU, at d = 3 (at
    this size no read lies within d = 1 of a reference), read with a card
    trace's stand-in: the counters read the program's log, and the
    pair dump's shared readers read the dense jobs; the device spans, which only a card has, and the kernels'
    shares, which need its trace, read nothing."""
    cell = "swissprot-pairdump-dense.reads-d1"
    _, config, traffic, _, layer = harness.resolve(bench_doc(), cell)
    assert set(READERS + SHARED) <= {m["name"] for m in layer}
    config = harness.override(config, SMALL, "config")
    traffic = harness.override(dict(traffic, d=3), SMALL, "traffic")
    drivers = harness.load_module("drivers", config["driver"])
    generator = harness.load_module("generators", traffic["generator"])
    loop = harness.load_module("loops", traffic["loop"])
    drv = drivers.Driver(config, traffic, generator, SEED,
                         torch.device("cpu"))
    plan = drv.plan()
    drv.warmup(plan)
    drv.trace_on()
    records, failed, _ = loop.run(drv, plan, 0.05, min_calls=3, traced=True)
    drv.trace_off()
    assert failed == 0
    ctx = SimpleNamespace(device=_card(), records=records, profiled=[],
                          driver=drv)
    log = drv.engine.pair_stats()[1:]           # past the warm-up's job
    assert _read("dense.emit_tiles", ctx) == pytest.approx(
        np.mean([j["emit_tiles"] for j in log]))
    assert _read("pairdump.join_attempts", ctx) == pytest.approx(
        np.mean([j["attempts"] for j in log]))
    assert _read("pairdump.job1_ms", ctx) > 0
    assert all(j["emit_tiles"] >= j["attempts"] >= 1 for j in log)
    for name in ("dense.count_dev_ms", "dense.emit_dev_ms",
                 "k6_count.roofline_pct", "k2_emit.roofline_pct"):
        assert _read(name, ctx) is None
    drv.release()


def test_readers_are_listed_for_the_dense_cells_alone():
    doc = bench_doc()
    assert CELLS == {c["name"] for c in doc["workloads"]
                     if c["config"] == "swissprot-pairdump-dense"}
    entries = {m["name"]: m for m in doc["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert set(m["workloads"]) == CELLS
        assert m["moves"] == "pairdump_reads_per_s"
        assert callable(harness.load_module("metrics", name).read)
    for name in SHARED:
        assert CELLS <= set(entries[name]["workloads"])
    rate = {m["name"]: m for m in doc["end_to_end"]}["pairdump_reads_per_s"]
    assert CELLS <= set(rate["workloads"])
