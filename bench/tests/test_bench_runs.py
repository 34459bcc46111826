"""Tiny runs of every cell, the staged ones too, on the CPU through the
whole harness: the result line has its fields and agrees with the
reference; the control (the reference with one stated guarantee broken)
and faults planted in the program's timed path come out not correct. One
test runs a short run of each cell on the card and skips elsewhere."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench import harness
from bench.tests.docs import bench_doc, full_doc

SEED = 2**31 + 977          # past 32 signed bits, as the driver's are
# big enough that pairs at exactly d and top-k ties at the tenth place
# exist, so the control and the faults have something to break
SMALL = {"config.refs.n": 20000, "traffic.queries.n": 6000,
         "traffic.batch": 64, "traffic.n_sets": 2, "traffic.warmup_calls": 1,
         "traffic.check_calls": 2}
TOPK_SMALL = dict(SMALL, **{"traffic.queries.n": 128})
DOC = full_doc()             # BENCHMARK.json's cells and the staged ones
CELLS = [c["name"] for c in DOC["workloads"]]


def small(cell):
    return TOPK_SMALL if cell.startswith("swissprot-topk") else SMALL


def run(cell, *, trace=False, control=False, seconds=0.5, seed=SEED,
        min_calls=1, **scale):
    return harness.run_cell(cell, seed, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            scale=dict(small(cell), **scale), control=control,
                            min_calls=min_calls, doc=DOC, log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_agrees_with_the_reference(cell):
    r = run(cell)
    assert list(r)[-1] == "compared"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    _, _, _, e2e, _ = harness.resolve(DOC, cell)
    assert set(r["metrics"]) == {m["name"] for m in e2e}
    for m in r["metrics"].values():
        assert m["value"] > 0
    assert all(c["value"] == 0 == c["limit"] for c in r["compared"].values())
    json.dumps(r)


@pytest.mark.parametrize("cell", ["swissprot-topk.proteome-b512",
                                  "swissprot-pairdump.reads-d2"])
def test_traced_run_reads_the_per_layer_metrics(cell):
    r = run(cell, trace=True)
    assert r["correct"] is True
    want = {"swissprot-topk.proteome-b512": {"topk.sig_ms", "topk.probe_ms",
                                             "topk.rerank_ms"},
            "swissprot-pairdump.reads-d2": {"pairdump.job1_ms",
                                            "pairdump.join_ms",
                                            "pairdump.join_attempts"}}[cell]
    # the device metrics need a card's trace: on the CPU they are left out
    assert set(r["metrics"]) == want


def test_trace_off_restores_the_untraced_path():
    """The profiled stretch after a traced pairdump window runs the path
    as the untraced window does: the stage wrappers are off again."""
    cell = "swissprot-pairdump.reads-d1"
    _, config, traffic, _, _ = harness.resolve(DOC, cell)
    config = harness.override(config, SMALL, "config")
    traffic = harness.override(traffic, SMALL, "traffic")
    drivers = harness.load_module("drivers", config["driver"])
    generator = harness.load_module("generators", traffic["generator"])
    drv = drivers.Driver(config, traffic, generator, SEED, torch.device("cpu"))
    sl = drv.engine.sl
    untraced = {n: getattr(sl, n).__func__
                for n in ("signatures", "feature_counts", "search")}
    drv.trace_on()
    drv.call(drv.plan()[0])
    assert drv.after_call()["attempts"] >= 1
    assert drv.trace_off() == [] and drv.after_call() == {}
    for name, fn in untraced.items():
        assert getattr(sl, name).__func__ is fn


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = run(cell, control=True)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["compared"].values())


def _stale(orig):
    last = {}

    def call(self, *a, **kw):
        out = orig(self, *a, **kw)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return call


def _half_topk(orig):
    def call(self, ids, lens):
        h = max(1, len(lens) // 2)
        nid, nd = orig(self, ids[:h], lens[:h])
        pad = np.full((len(lens) - h, nid.shape[1]), -1, nid.dtype)
        return np.concatenate([nid, pad]), np.concatenate([nd, pad])
    return call


def _half_pairs(orig):
    def call(self, ids, lens, **kw):
        h = max(1, len(lens) // 2)
        return orig(self, ids[:h], lens[:h], **kw)
    return call


def _altered_topk(orig):
    def call(self, ids, lens):
        nid, nd = orig(self, ids, lens)
        nid = nid.copy()
        r, c = np.argwhere(nid >= 0)[0]
        nid[r, c] = nid[r, c] + 1
        return nid, nd
    return call


def _altered_pairs(orig):
    def call(self, *a, **kw):
        res = orig(self, *a, **kw)
        pairs = res.pairs.clone()
        row = int(torch.nonzero(pairs[:, 0] >= 0)[0, 0])
        pairs[row, 2] += 1
        return res._replace(pairs=pairs)
    return call


def _signature_altered(orig):
    def build(cls, *a, **kw):
        index = orig(cls, *a, **kw)
        index.sigs[len(index.sigs) // 2, 0] ^= 1    # one bit of job 1's answer
        return index
    return classmethod(build)


FAULTS = {"state_unchanged": (_stale, _stale),
          "half_the_batch": (_half_topk, _half_pairs),
          "answer_altered": (_altered_topk, _altered_pairs)}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["signature_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.index.service import QueryEngine
    from repro_torch.index.store import SignatureIndex
    if fault == "signature_altered":
        monkeypatch.setattr(SignatureIndex, "build", _signature_altered(
            SignatureIndex.build.__func__))
    else:
        topk = cell.startswith("swissprot-topk")
        name = "query_batch" if topk else "search_pairs"
        wrap = FAULTS[fault][0 if topk else 1]
        monkeypatch.setattr(QueryEngine, name,
                            wrap(getattr(QueryEngine, name)))
    # three calls or more, every one judged: a stale answer shows from the
    # second call on
    r = run(cell, seconds=0.2, min_calls=3,
            **{"traffic.check_calls": 1000})
    assert r["correct"] is False, r["compared"]


@pytest.mark.cuda
def test_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    for cell in [c["name"] for c in bench_doc()["workloads"]]:
        proc = subprocess.run(
            [sys.executable, "bench/run.py", "--workload", cell, "--seed",
             str(SEED), "--seconds", "2", "--trace", "0"],
            cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
