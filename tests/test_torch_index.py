"""Parity of the port's bucket index and serving path with the JAX
reference: CSR arrays of ``build``, ``probe`` (candidates and overflow
flag), the dense and probe top-k through ``index_from_arrays`` (ties
included), and ``QueryEngine`` end to end with the Smith-Waterman re-rank,
for the band layout and the paper's flip layout. Exact equality
throughout."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.pipeline import LSHConfig as JCfg
from repro.index import service as j_svc
from repro.index.store import SignatureIndex as JIndex

from repro_torch.core.pipeline import LSHConfig as TCfg
from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                        make_protein_sets)
from repro_torch.index import service as t_svc
from repro_torch.index.interop import index_from_arrays
from repro_torch.index.store import SignatureIndex as TIndex, \
    config_fingerprint
from repro_torch.util import u32_to_i32

CFG = dict(k=3, T=13, f=64, d=2, scheme="splitmix")


@pytest.fixture(scope="module")
def corpus():
    return make_protein_sets(SyntheticProteinConfig(
        n_refs=260, n_homolog_queries=12, n_decoy_queries=4,
        ref_len_mean=110, ref_len_std=30, seed=3))


@pytest.fixture(scope="module")
def indexes(corpus):
    """The same corpus indexed by both packages, grown in two segments (of
    one shape, so the reference compiles job 1 once)."""
    ids, lens = corpus["ref_ids"], corpus["ref_lens"]
    j = JIndex.build(JCfg(**CFG), ids[:130], lens[:130])
    j.add(ids[130:], lens[130:])
    t = TIndex.build(TCfg(**CFG), ids[:130], lens[:130], device="cpu")
    t.add(ids[130:], lens[130:])
    return j, t


def _q_sigs(corpus):
    """Signatures of one engine batch's worth of queries (8: the shape the
    engines below serve, so the reference compiles its probe once)."""
    from repro_torch.core.pipeline import ScalLoPS
    return ScalLoPS(TCfg(**CFG), device="cpu").signatures(
        corpus["query_ids"][8:], corpus["query_lens"][8:])


def _csr_equal(a, b):
    assert len(a) == len(b)
    for (k1, o1, i1), (k2, o2, i2) in zip(a, b):
        assert k1.dtype == np.uint32 and o1.dtype == i1.dtype == np.int32
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(i1, i2)


def test_build_gives_the_reference_csr_arrays(indexes):
    j, t = indexes
    np.testing.assert_array_equal(t.sigs, j.sigs)
    np.testing.assert_array_equal(t.valid, j.valid)
    assert t.fingerprint == j.fingerprint
    assert t.epoch == j.epoch == 2
    j._ensure_built()
    t._ensure_built()
    for sj, st in zip(j.segments, t.segments):
        assert sj.base == st.base
        _csr_equal(st.csr, sj.csr)
    _csr_equal(t._csr_np, j._csr_np)
    np.testing.assert_array_equal(t.partition(1).host_slabs()[0],
                                  j.partition(1).host_slabs()[0])


def test_compact_keeps_the_bucket_table(corpus):
    ids, lens = corpus["ref_ids"], corpus["ref_lens"]
    t = TIndex.build(TCfg(**CFG), ids[:100], lens[:100], device="cpu")
    t.add(ids[100:], lens[100:])
    t._ensure_built()
    before = [tuple(a.copy() for a in band) for band in t._csr_np]
    t.compact()
    assert len(t.segments) == 1 and t.generation == 1
    whole = TIndex.build(TCfg(**CFG), ids, lens, device="cpu")
    whole._ensure_built()
    _csr_equal(t.segments[0].csr, before)
    _csr_equal(whole._csr_np, before)


@pytest.mark.parametrize("cap", [1, 4, 64])
def test_probe_matches(indexes, corpus, cap):
    j, t = indexes
    qs = _q_sigs(corpus)
    jc, jo = j.probe(qs.numpy().view(np.uint32), cap=cap)
    tc, to = t.probe(qs, cap=cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert bool(to) == bool(jo)
    np.testing.assert_array_equal(t.query_keys(qs).numpy(),
                                  np.asarray(j.query_keys(
                                      qs.numpy().view(np.uint32))).astype(
                                      np.int64))


def _exported(j):
    """The reference index's numpy state, as index_from_arrays takes it."""
    j.seal()
    return dict(cfg_dict=dataclasses.asdict(j.cfg), sigs=j.sigs,
                valid=j.valid, segments_csr=[s.csr for s in j.segments],
                layout=j.layout, bands=j.bands, interleave=j.interleave,
                key_hash=j.key_hash)


@pytest.mark.parametrize("k", [1, 5, 300])
def test_topk_dense_and_probe_match_through_interop(indexes, corpus, k):
    j, _ = indexes
    t = index_from_arrays(**_exported(j), device="cpu")
    qs = _q_sigs(corpus)
    qj = qs.numpy().view(np.uint32)
    tid, tdist = t_svc.topk_dense(t, qs, k=k)
    jid, jdist = j_svc.topk_dense(j, qj, k=k)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))
    tid, tdist, tcap, ttr = t_svc.topk_probe(t, qs, k=k, cap=2, max_cap=8)
    jid, jdist, jcap, jtr = j_svc.topk_probe(j, qj, k=k, cap=2, max_cap=8)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))
    assert (tcap, ttr) == (jcap, jtr)


def test_topk_breaks_ties_toward_the_lower_id():
    """Many refs at the same distance: the reference's top_k returns the
    lower index first; the port must pick the same ids in the same order.
    (Shapes as in the tests above, so the reference reuses its programs.)"""
    rng = np.random.default_rng(8)
    base = rng.integers(0, 2**32, (1, 2), dtype=np.uint64).astype(np.uint32)
    sigs = np.repeat(base, 130, axis=0)
    sigs[:, 0] ^= np.uint32(1) << rng.integers(0, 32, 130).astype(np.uint32)
    sigs[::13] = base                          # 10 at distance 0, the rest 1
    valid = np.ones(len(sigs), bool)
    valid[3] = False
    j = JIndex(JCfg(**CFG), sigs, valid)
    t = index_from_arrays(**_exported(j), device="cpu")
    q = np.repeat(base, 8, axis=0)
    for k in (5, 25):       # cut inside the distance-0 and -1 tie groups
        tid, tdist = t_svc.topk_dense(t, u32_to_i32(q), k=k)
        jid, jdist = j_svc.topk_dense(j, q, k=k)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))
        # every ref shares the query's buckets: a cap that holds them all
        # up front spares the reference one compile per retry
        tid, tdist, _, ttr = t_svc.topk_probe(t, u32_to_i32(q), k=k, cap=512)
        jid, jdist, _, jtr = j_svc.topk_probe(j, q, k=k, cap=512)
        assert not ttr and not jtr
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))


@pytest.mark.parametrize("mode", ["probe", "dense"])
@pytest.mark.parametrize("gap_mode", ["linear", "affine"])
def test_query_engine_rerank_matches(indexes, corpus, mode, gap_mode):
    j, t = indexes
    refs = (corpus["ref_ids"], corpus["ref_lens"])
    kw = dict(k=6, max_batch=8, mode=mode, rerank=True, gap_mode=gap_mode,
              probe_cap=4)
    te = t_svc.QueryEngine(t, t_svc.ServingConfig(**kw), ref_seqs=refs)
    je = j_svc.QueryEngine(j, j_svc.ServingConfig(**kw), ref_seqs=refs)
    a = te.query_batch(corpus["query_ids"], corpus["query_lens"])
    b = je.query_batch(corpus["query_ids"], corpus["query_lens"])
    np.testing.assert_array_equal(a[0], np.asarray(b[0]))
    np.testing.assert_array_equal(a[1], np.asarray(b[1]))
    st = te.stats()
    assert st["n_queries"] == len(corpus["query_lens"])
    assert st["n_batches"] == -(-len(corpus["query_lens"]) // 8)


def test_submit_flush_rowwave_rerank_matches(indexes, corpus):
    j, t = indexes
    refs = (corpus["ref_ids"], corpus["ref_lens"])
    kw = dict(k=6, max_batch=8, rerank=True, dp_kernel="rowwave")
    te = t_svc.QueryEngine(t, t_svc.ServingConfig(**kw), ref_seqs=refs)
    je = j_svc.QueryEngine(j, j_svc.ServingConfig(**kw), ref_seqs=refs)
    for n in range(6):
        row = corpus["query_ids"][n][:corpus["query_lens"][n]]
        te.submit(row)
        je.submit(row)
    te.submit("MKTAYIAKQRQISFVKSHFSRQ")
    je.submit("MKTAYIAKQRQISFVKSHFSRQ")
    assert te.pending() == 7
    for (ti, td), (ji, jd) in zip(te.flush(), je.flush()):
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_array_equal(td, np.asarray(jd))
    assert te.pending() == 0


def test_warmup_settles_and_stats_reset(indexes, corpus):
    _, t = indexes
    eng = t_svc.QueryEngine(t, t_svc.ServingConfig(
        k=3, max_batch=4, batch_ladder=(1, 2, 4)))
    n = eng.warmup(corpus["query_ids"][:5], corpus["query_lens"][:5])
    assert n >= 3 and eng.stats()["n_queries"] > 0
    eng.reset_stats()
    assert eng.stats()["n_batches"] == 0


def test_partition_helpers_match_reference():
    from repro.index import partition as j_part
    from repro_torch.index import partition as t_part
    rng = np.random.default_rng(9)
    keys = np.sort(rng.integers(0, 2**32, 50, dtype=np.uint64)
                   .astype(np.uint32))
    for n in (1, 3, 4):
        np.testing.assert_array_equal(t_part.bucket_owners(keys, n),
                                      j_part.bucket_owners(keys, n))
    offs = np.concatenate([[0], np.cumsum(rng.integers(0, 4, 50))]).astype(
        np.int32)
    ids = np.arange(offs[-1], dtype=np.int32)
    stacked = (keys[None, None], offs[None, None], ids[None, None])
    for a, b in zip(t_part.pad_slabs_pow2(*stacked),
                    j_part.pad_slabs_pow2(*stacked)):
        np.testing.assert_array_equal(a, b)


def test_fingerprint_matches_reference():
    from repro.index.store import config_fingerprint as j_fp
    for kw in (dict(layout="band", bands=2, key_hash="splitmix"),
               dict(layout="band", bands=3, interleave=False, n_shards=4),
               dict(layout="flip", bands=3)):
        assert config_fingerprint(TCfg(**CFG), **kw) == j_fp(JCfg(**CFG),
                                                             **kw)


# ------------------------------------------------------------ flip layout
FLIP_CFG = dict(k=3, T=13, f=32, d=1, scheme="splitmix")


@pytest.fixture(scope="module")
def flip_indexes(corpus):
    """The flip layout over the same refs: the reference's built from the
    port's job-1 arrays (one segment), the port's grown in two."""
    ids, lens = corpus["ref_ids"], corpus["ref_lens"]
    t = TIndex.build(TCfg(**FLIP_CFG), ids[:130], lens[:130], layout="flip",
                     device="cpu")
    t.add(ids[130:], lens[130:])
    j = JIndex(JCfg(**FLIP_CFG), t.sigs, t.valid, layout="flip")
    return j, t


def _flip_q_sigs(corpus):
    from repro_torch.core.pipeline import ScalLoPS
    return ScalLoPS(TCfg(**FLIP_CFG), device="cpu").signatures(
        corpus["query_ids"][8:], corpus["query_lens"][8:])


def test_flip_index_gives_the_reference_csr_arrays(flip_indexes):
    j, t = flip_indexes
    assert (t.n_bands, t.key_hash, t.bands) == (j.n_bands, j.key_hash,
                                                j.bands) == (1, "none", 2)
    assert t.fingerprint == j.fingerprint
    j._ensure_built()
    t._ensure_built()
    assert len(t.segments) == 2 and len(j.segments) == 1
    _csr_equal(t._csr_np, j._csr_np)
    one = TIndex(TCfg(**FLIP_CFG), t.sigs, t.valid, layout="flip",
                 device="cpu")
    one.seal()
    _csr_equal(one.segments[0].csr, j.segments[0].csr)
    np.testing.assert_array_equal(t.partition(1).host_slabs()[0],
                                  j.partition(1).host_slabs()[0])


@pytest.mark.parametrize("cap", [2, 64])
def test_flip_probe_and_topk_match(flip_indexes, corpus, cap):
    j, t = flip_indexes
    qs = _flip_q_sigs(corpus)
    qj = qs.numpy().view(np.uint32)
    np.testing.assert_array_equal(
        t.query_keys(qs).numpy(), np.asarray(j.query_keys(qj)).astype(
            np.int64))
    tc, to = t.probe(qs, cap=cap)
    jc, jo = j.probe(qj, cap=cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert bool(to) == bool(jo)
    tid, tdist, tcap, ttr = t_svc.topk_probe(t, qs, k=5, cap=cap, max_cap=64)
    jid, jdist, jcap, jtr = j_svc.topk_probe(j, qj, k=5, cap=cap, max_cap=64)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))
    assert (tcap, ttr) == (jcap, jtr)


def test_flip_engine_and_interop_match(flip_indexes, corpus):
    """A JAX-built flip index carried into the port serves the same top-k
    as the reference engine over it, and as the port's own flip index."""
    j, t = flip_indexes
    ti = index_from_arrays(**_exported(j), device="cpu")
    assert ti.layout == "flip" and ti.n_bands == 1
    _csr_equal(ti.segments[0].csr, j.segments[0].csr)
    kw = dict(k=4, max_batch=8, mode="probe", probe_cap=4)
    qi, ql = corpus["query_ids"], corpus["query_lens"]
    b = j_svc.QueryEngine(j, j_svc.ServingConfig(**kw)).query_batch(qi, ql)
    for idx in (ti, t):
        a = t_svc.QueryEngine(idx, t_svc.ServingConfig(**kw)).query_batch(
            qi, ql)
        np.testing.assert_array_equal(a[0], np.asarray(b[0]))
        np.testing.assert_array_equal(a[1], np.asarray(b[1]))


def test_flip_layout_refusals_match_reference():
    with pytest.raises(ValueError, match="f <= 32"):
        TIndex(TCfg(**CFG), np.zeros((0, 2), np.uint32), np.zeros(0, bool),
               layout="flip", device="cpu")
    t = TIndex(TCfg(**FLIP_CFG), np.zeros((0, 1), np.uint32),
               np.zeros(0, bool), layout="flip", device="cpu")
    with pytest.raises(ValueError, match="layout='band'"):
        t.device_band_keys
    with pytest.raises(ValueError, match="unknown index layout"):
        TIndex(TCfg(**FLIP_CFG), np.zeros((0, 1), np.uint32),
               np.zeros(0, bool), layout="lsh", device="cpu")


def test_rowwave_on_cuda_names_k7(monkeypatch):
    """``dp_kernel="rowwave"`` on CUDA operands launches kernel K7. With no
    card here, the device check answers CUDA and a stand-in takes the
    launch, so the test sees what the router hands the kernel."""
    from repro_torch.align.smith_waterman import GAP, dp_scores_block
    from repro_torch.kernels import ops, sw
    seen = []

    def fake_k7(qs, rs, *, gap):
        seen.append((qs.shape, rs.shape, gap))
        return torch.zeros(qs.shape[0], dtype=torch.int32)

    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(sw, "sw_rowwave", fake_k7)
    ops.reset_launches()
    q = torch.zeros((1, 4), dtype=torch.int8)
    dp_scores_block(q, torch.zeros((1, 6), dtype=torch.int8),
                    dp_kernel="rowwave")
    assert seen == [((1, 4), (1, 6), GAP)]
    assert ops.LAUNCHES["sw_rowwave"] == 1
    ops.reset_launches()
