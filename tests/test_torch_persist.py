"""Index persistence in the port, held against the JAX reference on the CPU:
segment directories and the legacy ``.npz`` container (append-only saves,
write generations, checksums, typed corruption, quarantine and
``recover=``, the legacy metadata eras), the fault plan and atomic writes
that the saves go through, occupancy statistics, the persistent family
forest, and interop both ways — what either package saves, the other
loads with identical CSR arrays, signatures and probe results.

Every compared value is an integer, a bool, a string or a JSON document:
the tolerance is exact equality."""
import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp

from repro.allpairs import FamilyForest as JForest
from repro.core.pipeline import LSHConfig as JCfg
from repro.index import band_stats as j_band_stats
from repro.index.service import topk_probe as j_topk_probe
from repro.index.store import SignatureIndex as JIndex

from repro_torch.allpairs import FamilyForest, lsh_self_join, union_find
from repro_torch.allpairs.graph import ForestMismatch
from repro_torch.core.pipeline import LSHConfig, ScalLoPS
from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                        make_protein_sets)
from repro_torch.faults import (FaultPlan, FaultSpec, InjectedFault,
                                ThreadKilled, atomic_write, fault_point)
from repro_torch.index import (IndexConfigMismatch, SignatureIndex,
                               band_stats, compare_schemes, occupancy_report)
from repro_torch.index.segments import CorruptSegment
from repro_torch.index.service import topk_probe

CPU = "cpu"
KW = dict(k=3, T=13, f=32, d=1)
CFG = LSHConfig(**KW)


@pytest.fixture(scope="module")
def data():
    return make_protein_sets(SyntheticProteinConfig(
        n_refs=120, n_homolog_queries=16, n_decoy_queries=16,
        ref_len_mean=90, ref_len_std=12, sub_rates=(0.04, 0.1), seed=77))


@pytest.fixture(scope="module")
def q_sigs(data):
    return ScalLoPS(CFG, device=CPU).signatures(data["query_ids"],
                                                data["query_lens"])


def _build(data, rows=slice(None), **kw):
    return SignatureIndex.build(CFG, data["ref_ids"][rows],
                                np.ascontiguousarray(data["ref_lens"][rows]),
                                device=CPU, **kw)


def _segmented(data, n_segments: int, **kw) -> SignatureIndex:
    """The corpus ingested in ``n_segments`` add() rounds."""
    n = len(data["ref_lens"])
    cuts = np.linspace(0, n, n_segments + 1).astype(int)
    idx = _build(data, slice(0, cuts[1]), **kw)
    for a, b in zip(cuts[1:-1], cuts[2:]):
        idx.add(data["ref_ids"][a:b], data["ref_lens"][a:b])
    return idx


def _probe(idx, q_sigs, k=5, cap=256):
    ids, dists, _, truncated = topk_probe(idx, q_sigs, k=k, cap=cap)
    assert not truncated
    return ids.numpy(), dists.numpy()


def _same_probe(a, b, q_sigs, **kw):
    for x, y in zip(_probe(a, q_sigs, **kw), _probe(b, q_sigs, **kw)):
        np.testing.assert_array_equal(x, y)


def _csr_equal(a, b):
    assert len(a) == len(b)
    for (k1, o1, i1), (k2, o2, i2) in zip(a, b):
        assert (k1.dtype, o1.dtype, i1.dtype) == (np.uint32, np.int32,
                                                  np.int32)
        for x, y in ((k1, k2), (o1, o2), (i1, i2)):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


# ------------------------------------------------------------ containers
def test_npz_roundtrip_and_config_check(tmp_path, data, q_sigs):
    idx = _build(data)
    path = tmp_path / "idx.npz"
    assert idx.save(path) == 1
    loaded = SignatureIndex.load(path, expected_cfg=CFG, device=CPU)
    _same_probe(idx, loaded, q_sigs, k=7, cap=128)
    assert loaded.epoch == 1 and loaded.lifecycle == (0, 1)
    with pytest.raises(IndexConfigMismatch):
        SignatureIndex.load(path, expected_cfg=LSHConfig(k=4, T=22, f=32),
                            device=CPU)
    # serving-time knobs do not invalidate the index
    SignatureIndex.load(path, expected_cfg=LSHConfig(
        **KW, max_pairs=123, join_method="band"), device=CPU)


def test_add_then_save_roundtrips(tmp_path, data, q_sigs):
    half = _build(data, slice(0, 48))
    half.add(data["ref_ids"][48:], data["ref_lens"][48:])
    path = tmp_path / "grown.npz"
    half.save(path)
    _same_probe(half, SignatureIndex.load(path, device=CPU), q_sigs)


def test_segmented_save_appends_only_new_segments(tmp_path, data, q_sigs):
    d = tmp_path / "idx"
    idx = _build(data, slice(0, 60))
    assert idx.save(d) == 1
    seg0 = d / "seg-g000-00000.npz"
    stamp = seg0.stat().st_mtime_ns
    idx.add(data["ref_ids"][60:], data["ref_lens"][60:])
    assert idx.save(d) == 1                 # only the new segment
    assert seg0.stat().st_mtime_ns == stamp
    assert sorted(p.name for p in d.glob("seg-*.npz")) == \
        ["seg-g000-00000.npz", "seg-g000-00001.npz"]
    loaded = SignatureIndex.load(d, expected_cfg=CFG, device=CPU)
    assert loaded.epoch == 2
    _same_probe(idx, loaded, q_sigs)


def test_segmented_compact_roundtrip(tmp_path, data, q_sigs):
    d = tmp_path / "idx"
    idx = _segmented(data, 3)
    idx.save(d)
    assert len(list(d.glob("seg-*.npz"))) == 3
    want = _probe(idx, q_sigs)
    idx.compact()
    assert idx.lifecycle == (1, 1)
    assert idx.save(d) == 1
    # a rewrite lands under a new write generation; the stale one goes
    assert sorted(p.name for p in d.glob("seg-*.npz")) == \
        ["seg-g001-00000.npz"]
    loaded = SignatureIndex.load(d, expected_cfg=CFG, device=CPU)
    for x, y in zip(want, _probe(loaded, q_sigs)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(lsh_self_join(idx).pairs,
                                  lsh_self_join(loaded).pairs)


def test_manifest_rejects_stale_config(tmp_path, data):
    d = tmp_path / "idx"
    _segmented(data, 2).save(d)
    with pytest.raises(IndexConfigMismatch):
        SignatureIndex.load(d, expected_cfg=LSHConfig(k=4, T=22, f=32),
                            device=CPU)


def test_save_detects_different_corpus_same_shape(tmp_path, data, q_sigs):
    d = tmp_path / "idx"
    _build(data).save(d)
    b = SignatureIndex.build(CFG, data["ref_ids"][::-1],
                             np.ascontiguousarray(data["ref_lens"][::-1]),
                             device=CPU)
    assert b.save(d) == 1                   # rewritten, not skipped
    loaded = SignatureIndex.load(d, expected_cfg=CFG, device=CPU)
    np.testing.assert_array_equal(loaded.sigs, b.sigs)
    _same_probe(loaded, b, q_sigs)


def _swap_rows(path):
    z = dict(np.load(path))
    z["sigs"] = z["sigs"][::-1].copy()      # same shape, other content
    np.savez_compressed(path, **z)


def test_manifest_rejects_swapped_segment_file(tmp_path, data):
    d = tmp_path / "idx"
    _segmented(data, 2).save(d)
    _swap_rows(d / "seg-g000-00001.npz")
    with pytest.raises(ValueError, match="content hash"):
        SignatureIndex.load(d, device=CPU)


def test_checksum_mismatch_is_typed_with_file(tmp_path, data):
    d = tmp_path / "idx"
    _segmented(data, 2).save(d)
    _swap_rows(d / "seg-g000-00001.npz")
    with pytest.raises(CorruptSegment) as ei:
        SignatureIndex.load(d, device=CPU)
    assert isinstance(ei.value, ValueError)
    assert "seg-g000-00001.npz" in ei.value.file


def test_manifest_rejects_reordered_segments(tmp_path, data):
    d = tmp_path / "idx"
    _segmented(data, 2).save(d)
    mpath = d / "manifest.json"
    m = json.loads(mpath.read_text())
    m["segments"] = m["segments"][::-1]
    mpath.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="reordered or corrupt"):
        SignatureIndex.load(d, device=CPU)


def _truncate(path, frac=3):
    blob = path.read_bytes()
    path.write_bytes(blob[:len(blob) // frac])


def test_truncated_segment_raises_typed_error_naming_file(tmp_path, data):
    d = tmp_path / "idx"
    _segmented(data, 3).save(d)
    _truncate(d / "seg-g000-00001.npz")
    with pytest.raises(CorruptSegment) as ei:
        SignatureIndex.load(d, device=CPU)
    assert "seg-g000-00001.npz" in ei.value.file
    assert "seg-g000-00001.npz" in str(ei.value)


def test_recovery_quarantines_tail_serves_valid_prefix(tmp_path, data,
                                                       q_sigs):
    d = tmp_path / "idx"
    _segmented(data, 3).save(d)              # 3 segments of 40 rows
    _truncate(d / "seg-g000-00001.npz")
    idx = SignatureIndex.load(d, recover=True, device=CPU)
    rec = idx.recovery
    assert rec is not None and "seg-g000-00001.npz" in rec["file"]
    assert rec["n_segments_dropped"] == 2    # the damaged one and its tail
    assert rec["n_rows_dropped"] == 80
    assert rec["n_rows_served"] == idx.size == 40
    assert sorted(rec["quarantined"]) == ["seg-g000-00001.npz",
                                          "seg-g000-00002.npz"]
    for f in rec["quarantined"]:             # evidence moved, not deleted
        assert (d / "quarantine" / f).exists() and not (d / f).exists()
    _same_probe(_build(data, slice(0, 40)), idx, q_sigs, cap=64)
    again = SignatureIndex.load(d, device=CPU)    # recovery is durable
    assert again.recovery is None and again.size == 40


def test_torn_manifest_write_fails_loudly_and_next_save_repairs(tmp_path,
                                                                data,
                                                                q_sigs):
    """A scripted torn write at ``store.write`` on the manifest (the new
    segment lands whole, the manifest tears): loading refuses instead of
    serving a guess, and the next save writes a whole directory again."""
    d = tmp_path / "idx"
    idx = _build(data, slice(0, 60))
    idx.save(d)
    idx.add(data["ref_ids"][60:], data["ref_lens"][60:])
    plan = FaultPlan().add("store.write", "torn", on=2, frac=0.5)
    with plan, pytest.raises(InjectedFault) as ei:
        idx.save(d)
    assert ei.value.kind == "torn" and plan.fired("store.write") == 1
    with pytest.raises(ValueError):
        SignatureIndex.load(d, device=CPU)
    assert idx.save(d) == 2                 # an unreadable manifest: all
    _same_probe(idx, SignatureIndex.load(d, expected_cfg=CFG, device=CPU),
                q_sigs)


def test_torn_segment_write_leaves_previous_manifest_loadable(tmp_path,
                                                              data):
    d = tmp_path / "idx"
    idx = _build(data, slice(0, 60))
    idx.save(d)
    idx.add(data["ref_ids"][60:], data["ref_lens"][60:])
    with FaultPlan().add("store.write", "torn", on=1, frac=0.3):
        with pytest.raises(InjectedFault):
            idx.save(d)
    old = SignatureIndex.load(d, device=CPU)
    assert old.size == 60 and old.recovery is None


def test_legacy_npz_torn_write_is_typed(tmp_path, data):
    p = tmp_path / "idx.npz"
    _build(data).save(p)
    _truncate(p, 2)
    with pytest.raises(CorruptSegment) as ei:
        SignatureIndex.load(p, device=CPU)
    assert "idx.npz" in ei.value.file


def _doctor_npz(path, drop_keys):
    """Rewrite a monolithic npz's meta without the given keys — what the
    files of earlier eras hold (their fingerprints omitted those fields,
    so they stay self-consistent)."""
    z = dict(np.load(path))
    meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
    for k in drop_keys:
        meta.pop(k, None)
    z["meta_json"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8)
    np.savez_compressed(path, **z)


@pytest.mark.parametrize("era,kw,drop", [
    # raw band keys, no key_hash or n_shards metadata
    ("raw_keys", dict(key_hash="none"), ["key_hash", "n_shards"]),
    # splitmix band keys, no n_shards metadata
    ("no_shards", dict(key_hash="splitmix"), ["n_shards"]),
    # n_shards in the metadata and the fingerprint
    ("sharded", dict(key_hash="splitmix", n_shards=4), []),
])
def test_legacy_npz_formats_load(tmp_path, data, q_sigs, era, kw, drop):
    idx = _build(data, **kw)
    path = tmp_path / f"{era}.npz"
    idx.save(path)
    _doctor_npz(path, drop)
    loaded = SignatureIndex.load(path, expected_cfg=CFG, device=CPU)
    assert loaded.key_hash == kw.get("key_hash", "splitmix")
    assert loaded.n_shards == kw.get("n_shards", 1)
    assert loaded.epoch == 1
    _same_probe(idx, loaded, q_sigs)
    # ...and a legacy index keeps growing through the segmented lifecycle
    loaded.add(data["query_ids"], data["query_lens"])
    assert loaded.epoch == 2
    d = tmp_path / f"{era}_grown"
    loaded.save(d)
    _same_probe(loaded, SignatureIndex.load(d, expected_cfg=CFG,
                                            device=CPU), q_sigs)


def test_compact_noop_when_already_compact(data):
    idx = _segmented(data, 2)
    idx.compact()
    gen = idx.generation
    idx.compact()
    assert idx.generation == gen and len(idx.segments) == 1


def test_partition_bucket_and_entry_counts_match_reference(data):
    t = _segmented(data, 2)
    j = JIndex.build(JCfg(**KW), data["ref_ids"], data["ref_lens"])
    for n in (1, 3):
        pt, pj = t.partition(n), j.partition(n)
        np.testing.assert_array_equal(pt.n_buckets, pj.n_buckets)
        np.testing.assert_array_equal(pt.n_entries, pj.n_entries)
        assert pt.n_entries.sum() == t.n_bands * int(t.valid.sum())


# ------------------------------------------------------------ interop
@pytest.fixture(scope="module")
def reference_index(data):
    """The corpus indexed by the reference in two segments."""
    j = JIndex.build(JCfg(**KW), data["ref_ids"][:60], data["ref_lens"][:60])
    j.add(data["ref_ids"][60:], data["ref_lens"][60:])
    return j


def _reference_probe(j, q_sigs):
    ids, dists, *_ = j_topk_probe(
        j, jnp.asarray(q_sigs.numpy().view(np.uint32)), k=5, cap=256)
    return np.asarray(ids), np.asarray(dists)


@pytest.mark.parametrize("container", ["dir", "npz"])
def test_reference_saved_index_loads_in_the_port(tmp_path, reference_index,
                                                 q_sigs, container):
    j = reference_index
    path = tmp_path / ("idx" if container == "dir" else "idx.npz")
    j.save(path)
    t = SignatureIndex.load(path, expected_cfg=CFG, device=CPU)
    np.testing.assert_array_equal(t.sigs, j.sigs)
    np.testing.assert_array_equal(t.valid, j.valid)
    assert t.fingerprint == j.fingerprint
    # the monolithic container holds the merged table as one segment
    assert t.epoch == (j.epoch if container == "dir" else 1)
    if container == "dir":
        for st, sj in zip(t.segments, j.segments):
            assert st.base == sj.base
            _csr_equal(st.csr, sj.csr)
    t._ensure_built()
    j._ensure_built()
    _csr_equal(t._csr_np, j._csr_np)
    for x, y in zip(_probe(t, q_sigs), _reference_probe(j, q_sigs)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("container", ["dir", "npz"])
def test_port_saved_index_loads_in_the_reference(tmp_path, data,
                                                 reference_index, q_sigs,
                                                 container):
    t = _build(data, slice(0, 60))
    t.add(data["ref_ids"][60:], data["ref_lens"][60:])
    path = tmp_path / ("idx" if container == "dir" else "idx.npz")
    t.save(path)
    j = JIndex.load(path, expected_cfg=JCfg(**KW))
    np.testing.assert_array_equal(j.sigs, t.sigs)
    np.testing.assert_array_equal(j.valid, t.valid)
    assert j.fingerprint == t.fingerprint
    assert j.epoch == (t.epoch if container == "dir" else 1)
    if container == "dir":
        for st, sj in zip(t.segments, j.segments):
            _csr_equal(st.csr, sj.csr)
        # the manifest is the reference's own, key for key
        ref_dir = tmp_path / "ref"
        reference_index.save(ref_dir)
        mine = json.loads((path / "manifest.json").read_text())
        theirs = json.loads((ref_dir / "manifest.json").read_text())
        assert mine == theirs
    t._ensure_built()
    j._ensure_built()
    _csr_equal(t._csr_np, j._csr_np)
    for x, y in zip(_probe(t, q_sigs), _reference_probe(j, q_sigs)):
        np.testing.assert_array_equal(x, y)


def test_forest_files_load_in_both_packages(tmp_path):
    edges = np.array([[0, 3], [3, 7], [1, 2], [8, 9]])
    mine, theirs = FamilyForest(11), JForest(11)
    mine.union_edges(edges)
    theirs.union_edges(edges)
    mine.save(tmp_path / "t.npz", generation=4)
    theirs.save(tmp_path / "j.npz", generation=4)
    np.testing.assert_array_equal(
        JForest.load(tmp_path / "t.npz", expect_n=11,
                     expect_generation=4).labels(), theirs.labels())
    np.testing.assert_array_equal(
        FamilyForest.load(tmp_path / "j.npz", expect_n=11,
                          expect_generation=4).labels(), mine.labels())


# ------------------------------------------------------------ family forest
def test_forest_generation_and_size_mismatch_typed(tmp_path):
    fpath = tmp_path / "families.npz"
    forest = FamilyForest(12)
    forest.union_edges(np.array([[0, 1], [2, 3]]))
    forest.save(fpath, generation=2)
    ok = FamilyForest.load(fpath, expect_n=12, expect_generation=2)
    np.testing.assert_array_equal(ok.labels(), forest.labels())
    with pytest.raises(ForestMismatch) as ei:
        FamilyForest.load(fpath, expect_generation=3)
    assert "families.npz" in ei.value.file and "generation" in str(ei.value)
    with pytest.raises(ForestMismatch, match="stale forest"):
        FamilyForest.load(fpath, expect_n=99)
    _truncate(fpath, 2)                      # torn forest file: typed too
    with pytest.raises(ForestMismatch, match="unreadable"):
        FamilyForest.load(fpath)
    # files without metadata load and skip the generation check
    np.savez_compressed(fpath, parent=forest.parent, size=forest._size)
    FamilyForest.load(fpath, expect_generation=7)


def test_forest_roundtrip_and_shrink(tmp_path):
    forest = FamilyForest(10)
    forest.union_edges(np.array([[0, 3], [3, 7], [1, 2]]))
    p = tmp_path / "families.npz"
    forest.save(p)
    loaded = FamilyForest.load(p)
    np.testing.assert_array_equal(loaded.labels(), forest.labels())
    np.testing.assert_array_equal(loaded.labels(),
                                  union_find(10, np.array([[0, 3], [3, 7],
                                                           [1, 2]])))
    loaded.grow(12)
    assert loaded.n == 12
    with pytest.raises(ValueError):
        loaded.grow(5)


# ------------------------------------------------------------ fault plan
def test_plan_counts_calls_and_fires_exactly():
    plan = FaultPlan().add("a.site", "raise", on={2, 4})
    with plan:
        assert fault_point("a.site") is None            # call 1
        with pytest.raises(InjectedFault) as ei:
            fault_point("a.site")                       # call 2 fires
        assert ei.value.site == "a.site" and ei.value.call == 2
        assert fault_point("a.site") is None            # call 3
        with pytest.raises(InjectedFault):
            fault_point("a.site")                       # call 4 fires
        assert fault_point("other.site") is None        # its own counter
    assert plan.calls("a.site") == 4 and plan.calls("other.site") == 1
    assert plan.fired("a.site") == 2 and plan.fired() == 2
    assert plan.ledger() == [("a.site", 2, "raise"), ("a.site", 4, "raise")]
    assert plan.unfired() == []
    s = plan.summary()
    assert s["scripted"] == {"a.site:raise": 2}
    assert s["fired"] == {"a.site:raise": 2}


def test_plan_unfired_flags_unreached_calls():
    plan = FaultPlan().add("s", "raise", on=5)
    with plan:
        fault_point("s")
    unfired = plan.unfired()
    assert len(unfired) == 1 and unfired[0].site == "s"


def test_plan_kinds():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("s", "explode")
    with pytest.raises(ValueError, match="1-based"):
        FaultSpec("s", on=0)
    slept = []
    plan = FaultPlan(sleep=slept.append)
    plan.add("k", "kill", on=1).add("l", "latency", on=1, delay_s=0.25)
    plan.add("t", "torn", on=1, frac=0.3)
    with plan:
        with pytest.raises(ThreadKilled) as ei:
            fault_point("k")
        assert isinstance(ei.value, InjectedFault)
        assert fault_point("l") is None and slept == [0.25]
        spec = fault_point("t")                 # torn: returned, not raised
        assert spec is not None and spec.frac == 0.3


def test_plan_install_is_exclusive_and_scoped():
    assert fault_point("nowhere") is None
    p1, p2 = FaultPlan(), FaultPlan()
    with p1:
        with pytest.raises(RuntimeError, match="already installed"):
            p2.install()
    with p2:
        fault_point("s")
    assert p2.calls("s") == 1 and p1.calls("nowhere") == 0


def test_atomic_write_writes_and_cleans_tmp(tmp_path):
    dest = tmp_path / "out.bin"
    atomic_write(dest, lambda fh: fh.write(b"hello"))
    assert dest.read_bytes() == b"hello"
    assert list(tmp_path.iterdir()) == [dest]


def test_atomic_write_crash_preserves_old_content(tmp_path):
    dest = tmp_path / "out.bin"
    dest.write_bytes(b"old-and-complete")

    def boom(fh):
        fh.write(b"new-but-")
        raise RuntimeError("writer died mid-payload")

    with pytest.raises(RuntimeError):
        atomic_write(dest, boom)
    assert dest.read_bytes() == b"old-and-complete"
    assert list(tmp_path.iterdir()) == [dest]


def test_atomic_write_scripted_torn_write(tmp_path):
    dest = tmp_path / "seg.bin"
    dest.write_bytes(b"previous")
    payload = b"0123456789" * 10
    with FaultPlan().add("store.write", "torn", on=1, frac=0.5):
        with pytest.raises(InjectedFault) as ei:
            atomic_write(dest, lambda fh: fh.write(payload))
    assert ei.value.kind == "torn"
    assert dest.read_bytes() == payload[:50]


# ------------------------------------------------------------ stats
def _stats_refs(n=512, seed=9):
    d = make_protein_sets(SyntheticProteinConfig(
        n_refs=n, n_homolog_queries=0, n_decoy_queries=0,
        ref_len_mean=120, ref_len_std=20, seed=seed))
    return d["ref_ids"], d["ref_lens"]


def test_band_stats_match_reference_and_are_consistent():
    ids, lens = _stats_refs()
    idx = SignatureIndex.build(CFG, ids, lens, device=CPU)
    stats = band_stats(idx)
    want = j_band_stats(JIndex.build(JCfg(**KW), ids, lens))
    assert [dataclasses.asdict(s) for s in stats] == \
        [dataclasses.asdict(s) for s in want]
    assert len(stats) == idx.n_bands
    n_valid = int(idx.valid.sum())
    for s in stats:
        assert s.n_entries == n_valid
        assert 1 <= s.max_bucket <= n_valid
        assert 0.0 <= s.entropy_frac <= 1.0
        assert s.expected_probe >= 1.0
        assert sum(s.hist.values()) == s.n_buckets
    assert "entropy" in occupancy_report(idx)


def test_empty_index_stats():
    stats = band_stats(SignatureIndex.build(
        CFG, np.zeros((0, 1), np.int8), np.zeros((0,), np.int32),
        device=CPU))
    assert len(stats) == 2 and all(s.n_entries == 0 for s in stats)


def test_splitmix_recovers_key_diversity():
    ids, lens = _stats_refs()
    res = compare_schemes(CFG, ids, lens, device=CPU)
    for b in range(len(res["java"])):
        java, splitmix = res["java"][b], res["splitmix"][b]
        assert splitmix.entropy_frac > java.entropy_frac
        assert splitmix.expected_probe < java.expected_probe
        assert splitmix.max_bucket <= java.max_bucket
    assert min(s.entropy_frac for s in res["splitmix"]) > 0.9
