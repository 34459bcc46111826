"""The dense pair dump (``join_method="dense"``: K6 counts, K2's emission
tiles) through ``QueryEngine.search_pairs``, traced from inside the port:
the job log's dense fields (``count_dev_s``, ``emit_dev_s``,
``emit_tiles``, ``emit_rows``) and the ``pairs.join.count`` and
``pairs.join.emit`` spans inside each ``pairs.join``; the stage marks
change nothing of the join's output.

The dump itself is held to the JAX reference's ``search_pairs`` in
``test_torch_search.py``, and the card's host syncs of the dense loop in
``test_torch_obs_pairs.py``. This file runs on the CPU and imports no
jax.
"""
import math

import numpy as np
import pytest

from repro_torch.core import hamming
from repro_torch.core.pipeline import LSHConfig
from repro_torch.data.synthetic import SyntheticProteinConfig, \
    make_protein_sets
from repro_torch.index.service import QueryEngine, ServingConfig
from repro_torch.index.store import SignatureIndex
from repro_torch.obs.trace import TRACER
from repro_torch.util import u32_to_i32

DENSE_KEYS = ("count_dev_s", "emit_dev_s", "emit_tiles", "emit_rows")


@pytest.fixture(scope="module")
def data():
    return make_protein_sets(SyntheticProteinConfig(
        n_refs=96, n_homolog_queries=24, n_decoy_queries=24,
        ref_len_mean=100, ref_len_std=15, sub_rates=(0.03, 0.1), seed=17))


def _cfg(method="dense", d=1, max_pairs=1 << 14):
    return dict(k=3, T=13, f=32, d=d, scheme="java", join_method=method,
                max_pairs=max_pairs)


def _engine(data, **kw):
    index = SignatureIndex.build(LSHConfig(**_cfg(**kw)), data["ref_ids"],
                                 data["ref_lens"], device="cpu")
    return QueryEngine(index, ServingConfig(k=3))


@pytest.fixture
def tracer_off():
    TRACER.disable()
    TRACER.clear()
    yield TRACER
    TRACER.disable()
    TRACER.clear()


def _hits_per_query(q_sigs, r_sigs, d):
    x = np.bitwise_xor(q_sigs[:, None, :].view(np.uint32),
                       r_sigs[None, :, :].view(np.uint32))
    dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
    return (dist <= d).sum(1)


@pytest.mark.parametrize("d", [1, 3])
def test_job_log_counts_the_emission_tiles(data, monkeypatch, d):
    """Three query rows a tile: each attempt emits the queries with hits
    that start inside its buffer, in tiles of three; the log sums the
    tiles and rows over the attempts. A CPU pipeline has no device
    spans."""
    eng = _engine(data, d=d)
    R = eng.index.size
    monkeypatch.setattr(hamming, "_TILE_BYTES",
                        3 * R * hamming._TILE_BYTES_PER_CELL)
    eng.search_pairs(data["query_ids"], data["query_lens"], max_pairs=4)
    [job] = eng.pair_stats()
    q = eng.sl.signatures(data["query_ids"], data["query_lens"]).numpy()
    counts = _hits_per_query(q, eng.index.sigs.view(np.int32), d)
    offsets = np.cumsum(counts) - counts
    rows = [int(((counts > 0) & (offsets < 4 << a)).sum())
            for a in range(job["attempts"])]
    assert job["emit_rows"] == sum(rows)
    assert job["emit_tiles"] == sum(math.ceil(n / 3) for n in rows) > \
        job["attempts"]
    assert job["count_dev_s"] is None and job["emit_dev_s"] is None
    assert job["join_dev_s"] is None and job["job1_dev_s"] is None


@pytest.mark.parametrize("method", ["flip", "band"])
def test_other_joins_log_no_dense_fields(data, method):
    eng = _engine(data, method=method)
    eng.search_pairs(data["query_ids"], data["query_lens"])
    [job] = eng.pair_stats()
    assert {k: job[k] for k in DENSE_KEYS} == dict.fromkeys(DENSE_KEYS)


def test_stage_spans_nest_in_each_join_span(data, monkeypatch, tracer_off):
    eng = _engine(data, d=3)
    monkeypatch.setattr(hamming, "_TILE_BYTES",
                        4 * eng.index.size * hamming._TILE_BYTES_PER_CELL)
    TRACER.enable()
    for _ in range(2):
        eng.search_pairs(data["query_ids"], data["query_lens"], max_pairs=8)
    TRACER.disable()
    spans = TRACER.spans()
    roots = [s for s in spans if s["name"] == "search_pairs"]
    assert len(roots) == 2
    for root, job in zip(roots, eng.pair_stats()):
        mine = [s for s in spans
                if s["args"].get("trace") == root["args"]["trace"]]
        joins = [s for s in mine if s["name"] == "pairs.join"]
        counts = [s for s in mine if s["name"] == "pairs.join.count"]
        emits = [s for s in mine if s["name"] == "pairs.join.emit"]
        assert len(joins) == len(counts) == len(emits) == job["attempts"] > 1
        for j, c, e in zip(joins, counts, emits):
            lo, hi = j["ts"] - 1e-6, j["ts"] + j["dur"] + 1e-6
            assert lo <= c["ts"] and c["ts"] + c["dur"] <= e["ts"] + 1e-6
            assert e["ts"] + e["dur"] <= hi
            assert c["args"]["dev_ms"] is None is e["args"]["dev_ms"]
        assert sum(e["args"]["tiles"] for e in emits) == job["emit_tiles"]
        assert [e["args"]["tiles"] > 0 for e in emits] == \
            [True] * len(emits)


def test_dense_dump_records_nothing_with_the_tracer_off(data, tracer_off):
    eng = _engine(data, d=3)
    eng.search_pairs(data["query_ids"], data["query_lens"], max_pairs=4)
    assert len(TRACER) == 0
    assert eng.pair_stats()[0]["emit_tiles"] >= 1     # the log is always on


class _Recorder:
    def __init__(self):
        self.marks, self.tiles = 0, []

    def mark(self):
        self.marks += 1

    def tile(self, rows):
        self.tiles.append(rows)


@pytest.mark.parametrize("max_pairs", [3, 40, 10_000])
def test_stage_marks_leave_the_output_alone(monkeypatch, max_pairs):
    """The join with and without stage marks gives one buffer and count,
    bit for bit; three marks a call and a tile call a tile."""
    rng = np.random.default_rng(29)
    r = rng.integers(0, 2**32, (60, 1), dtype=np.uint32)
    q = np.concatenate([r[::2], r[1::3] ^ np.uint32(1 << 5)])
    q[::4, 0] ^= np.uint32(0b110)
    monkeypatch.setattr(hamming, "_TILE_BYTES",
                        5 * 60 * hamming._TILE_BYTES_PER_CELL)
    args = (u32_to_i32(q), u32_to_i32(r), 3, max_pairs)
    rec = _Recorder()
    plain = hamming.threshold_pairs(*args)
    marked = hamming.threshold_pairs(*args, stages=rec)
    for a, b in zip(plain, marked):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert rec.marks == 3
    assert all(1 <= n <= 5 for n in rec.tiles) and rec.tiles
