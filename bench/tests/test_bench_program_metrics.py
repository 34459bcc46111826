"""The readers of the program's own pair-dump instruments
(``pairdump.job1_dev_ms``, ``pairdump.join_dev_ms``, ``pairdump.h2d_mb``,
``pairdump.keys_sorted_m``): they read ``QueryEngine.pair_stats()``'s job
log over the window's jobs alone, and read nothing without a card's
trace, with a log shorter than the window, or from a program without the
log."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench import harness
from bench.tests.docs import bench_doc
from repro_torch.core.join import flip_masks

SEED = 2**31 + 977
SMALL = {"config.refs.n": 3000, "traffic.queries.n": 600,
         "traffic.n_sets": 2, "traffic.warmup_calls": 1}
READERS = ("pairdump.job1_dev_ms", "pairdump.join_dev_ms", "pairdump.h2d_mb",
           "pairdump.keys_sorted_m")
CARD = SimpleNamespace(busy_s=1.0, window_s=1.0, ops=[])   # a trace's stand-in


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def _job(t0, t1, **kw):
    job = dict(t0=t0, t1=t1, attempts=2, h2d_bytes=3_000_000,
               job1_dev_s=0.010, join_dev_s=(0.002, 0.003))
    job.update(kw)
    return job


def _ctx(log, records, device=CARD, method="flip", profiled=()):
    index = SimpleNamespace(size=100_000, cfg=SimpleNamespace(
        join_method=method, f=32, d=1))
    engine = SimpleNamespace(pair_stats=lambda: list(log), index=index)
    return SimpleNamespace(device=device, records=records,
                           profiled=list(profiled),
                           driver=SimpleNamespace(engine=engine))


def _records(*spans):
    return [harness.Record(None, object(), a, b) for a, b in spans]


def test_readers_pick_only_the_windows_jobs():
    """Warm-up before the window and the profiled stretch after it are in
    the log too; the readers take the jobs inside the window's stamps."""
    far = dict(attempts=9, h2d_bytes=9e9, job1_dev_s=9.0)
    log = [_job(0.0, 1.0, **far),
           _job(10.0, 11.0),
           _job(11.0, 12.0, attempts=1, h2d_bytes=1_000_000,
                job1_dev_s=0.020, join_dev_s=(0.001,)),
           _job(13.0, 14.0, **far)]
    ctx = _ctx(log, _records((10.0, 11.0), (11.0, 12.0)),
               profiled=_records((13.0, 14.0)))
    got = {n: _read(n, ctx) for n in READERS}
    assert got == pytest.approx({"pairdump.job1_dev_ms": 15.0,
                                 "pairdump.join_dev_ms": 3.0,
                                 "pairdump.h2d_mb": 2.0,
                                 "pairdump.keys_sorted_m": 1.5 * 33 * 0.1})


@pytest.mark.parametrize("method", ["flip", "band", "dense"])
def test_keys_sorted_counts_the_flip_joins_keys(method):
    """A flip join sorts a key a mask a reference on every attempt; the
    reading is None for an index that is not flip-joined."""
    ctx = _ctx([_job(10.0, 11.0, attempts=3)], _records((10.0, 11.0)),
               method=method)
    got = _read("pairdump.keys_sorted_m", ctx)
    if method == "flip":
        assert got == pytest.approx(3 * len(flip_masks(32, 1)) * 0.1)
    else:
        assert got is None


@pytest.mark.parametrize("case", ["no_card_trace", "short_log", "no_log",
                                  "no_device_span"])
def test_readers_read_nothing_where_they_cannot(case):
    log = [_job(10.0, 11.0), _job(11.0, 12.0)]
    records = _records((10.0, 11.0), (11.0, 12.0))
    ctx = _ctx(log, records)
    if case == "no_card_trace":
        ctx.device = None
    elif case == "short_log":       # the bounded log lost a window's job
        ctx = _ctx(log[1:], records)
    elif case == "no_log":          # a program without pair_stats
        del ctx.driver.engine.pair_stats
    else:                           # the CPU: no device spans, counters only
        ctx = _ctx([_job(10.0, 11.0, job1_dev_s=None, join_dev_s=None),
                    _job(11.0, 12.0, job1_dev_s=None, join_dev_s=None)],
                   records)
    got = {n: _read(n, ctx) for n in READERS}
    if case == "no_device_span":
        assert got["pairdump.job1_dev_ms"] is None
        assert got["pairdump.join_dev_ms"] is None
        assert got["pairdump.h2d_mb"] == pytest.approx(3.0)
        assert got["pairdump.keys_sorted_m"] == pytest.approx(2 * 33 * 0.1)
    else:
        assert got == dict.fromkeys(READERS)


def test_readers_of_a_real_window_on_the_cpu():
    """A short window of the pair-dump driver on the CPU, read with a card
    trace's stand-in: the keys read what the shapes give; a CPU pipeline
    uploads nothing; the device spans, which only a card has, read
    nothing."""
    cell = "swissprot-pairdump.reads-d2"
    _, config, traffic, _, layer = harness.resolve(bench_doc(), cell)
    assert set(READERS) <= {m["name"] for m in layer}
    config = harness.override(config, SMALL, "config")
    traffic = harness.override(traffic, SMALL, "traffic")
    drivers = harness.load_module("drivers", config["driver"])
    generator = harness.load_module("generators", traffic["generator"])
    loop = harness.load_module("loops", traffic["loop"])
    drv = drivers.Driver(config, traffic, generator, SEED,
                         torch.device("cpu"))
    plan = drv.plan()
    drv.warmup(plan)
    records, failed, _ = loop.run(drv, plan, 0.05, min_calls=3)
    assert failed == 0
    ctx = SimpleNamespace(device=CARD, records=records, profiled=[],
                          driver=drv)
    log = drv.engine.pair_stats()
    assert len(log) == len(records) + 1             # the warm-up's job too
    attempts = np.mean([j["attempts"] for j in log[1:]])
    assert len(flip_masks(32, 2)) == 529
    assert _read("pairdump.keys_sorted_m", ctx) == pytest.approx(
        529 * drv.index.size * attempts / 1e6)
    assert _read("pairdump.h2d_mb", ctx) == 0.0
    assert _read("pairdump.job1_dev_ms", ctx) is None
    assert _read("pairdump.join_dev_ms", ctx) is None
    drv.release()


def test_readers_are_listed_for_the_pairdump_cells_alone():
    doc = bench_doc()
    cells = {c["name"] for c in doc["workloads"]
             if c["config"] == "swissprot-pairdump"}
    entries = {m["name"]: m for m in doc["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert set(m["workloads"]) == cells
        assert m["moves"] == "pairdump_reads_per_s"
        assert m["source"] in ("program_span", "program_counter")
        assert callable(harness.load_module("metrics", name).read)
