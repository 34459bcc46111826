"""Parity of the port's all-pairs path (``repro_torch.allpairs``) with the
JAX reference (``repro.allpairs``), on the CPU where every kernel runs as
its plain twin: the self-join (pairs, CSR, overflow errors), the tiled
Smith-Waterman waves (scores, PID, prefilter survivors and lower bounds,
the row wave), clustering, ``all_pairs_search`` end to end and
``all_pairs_ingest``. The same numpy inputs go through both packages;
every output is integer or a PID computed from integers, so equality is
exact."""
import numpy as np
import pytest
import torch

from repro.align.smith_waterman import sw_wave_pid as j_sw_wave_pid
from repro.allpairs import AllPairsConfig as JAllPairs
from repro.allpairs import WaveConfig as JWave
from repro.allpairs import all_pairs_search as j_search
from repro.allpairs import lsh_self_join as j_join
from repro.allpairs import score_pairs as j_score
from repro.allpairs import union_find as j_union_find
from repro.core import LSHConfig as JCfg
from repro.index import SignatureIndex as JIndex

from repro_torch.align.smith_waterman import dp_scores_block, sw_wave_pid
from repro_torch.allpairs import (AllPairsConfig, FamilyForest, WaveConfig,
                                  all_pairs_ingest, all_pairs_search,
                                  brute_force_collisions, cluster_families,
                                  forest_from_result, lsh_delta_join,
                                  lsh_self_join, score_pairs, union_find)
from repro_torch.core.alphabet import PAD
from repro_torch.core.pipeline import LSHConfig
from repro_torch.data.synthetic import FamilyCorpusConfig, make_family_corpus
from repro_torch.index.store import SignatureIndex

KW = dict(k=3, T=13, f=32, d=1)


@pytest.fixture(scope="module")
def corpus():
    return make_family_corpus(FamilyCorpusConfig(
        n_families=10, family_size=3, n_singletons=30, len_mean=90,
        len_std=12, sub_rate=0.04, seed=5))


@pytest.fixture(scope="module")
def indexes(corpus):
    """The corpus indexed by both packages."""
    return (JIndex.build(JCfg(**KW), corpus["ids"], corpus["lens"]),
            SignatureIndex.build(LSHConfig(**KW), corpus["ids"],
                                 corpus["lens"], device="cpu"))


def _random_pairs(corpus, m, seed):
    rng = np.random.default_rng(seed)
    n = len(corpus["lens"])
    return np.stack([rng.integers(0, n, m), rng.integers(0, n, m)],
                    axis=1).astype(np.int32)


def _same_scores(a, b):
    np.testing.assert_array_equal(a.scores, b.scores)
    for f in ("pid", "aln_len", "ungapped", "kept"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert (a.n_waves, a.n_shapes) == (b.n_waves, b.n_shapes)


# ---------------------------------------------------------------- self-join
def test_selfjoin_matches_bruteforce_collisions(indexes):
    j_idx, t_idx = indexes
    want = j_join(j_idx)
    join = lsh_self_join(t_idx)
    np.testing.assert_array_equal(join.pairs, want.pairs)
    np.testing.assert_array_equal(join.indptr, want.indptr)
    np.testing.assert_array_equal(join.indices, want.indices)
    got = {tuple(p) for p in join.pairs}
    assert got == brute_force_collisions(t_idx)
    assert (join.pairs[:, 0] < join.pairs[:, 1]).all()
    assert len(got) == join.n_candidates == len(join.pairs)


def test_selfjoin_max_grow_raises(indexes):
    with pytest.raises(RuntimeError, match="max_grow"):
        lsh_self_join(indexes[1], max_pairs=2, max_grow=2)


def test_selfjoin_hamming_filter_subset(indexes):
    j_idx, t_idx = indexes
    filt = lsh_self_join(t_idx, d=1)
    np.testing.assert_array_equal(filt.pairs, j_join(j_idx, d=1).pairs)
    assert {tuple(p) for p in filt.pairs} <= {
        tuple(p) for p in lsh_self_join(t_idx).pairs}


def test_selfjoin_empty_corpus():
    idx = SignatureIndex.build(LSHConfig(**KW), np.zeros((0, 1), np.int8),
                               np.zeros((0,), np.int32), device="cpu")
    join = lsh_self_join(idx)
    assert join.n_candidates == 0 and join.indptr.shape == (1,)


def test_unported_routes_raise(indexes):
    """Only the legacy orchestration is refused (by decision); the
    sharded routes are held to the reference in
    test_torch_sharded_allpairs.py."""
    with pytest.raises(NotImplementedError, match="Queue 1, 'Not ported'"):
        lsh_self_join(indexes[1], join_impl="legacy")
    with pytest.raises(NotImplementedError, match="Queue 1, 'Not ported'"):
        lsh_delta_join(indexes[1], base_size=0, join_impl="legacy")


@pytest.mark.parametrize("d", [None, 1])
def test_self_join_flip_layout_matches_reference(d):
    """A flip-layout index self-joins through the sort-dedup pack (the
    keyed pack needs band keys, which only the band layout has), as the
    reference does: 300 refs, seed 41."""
    from repro.data import SyntheticProteinConfig, make_protein_sets
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=300, n_homolog_queries=4, n_decoy_queries=4,
        ref_len_mean=90, ref_len_std=12, sub_rates=(0.04, 0.1), seed=41))
    want = j_join(JIndex.build(JCfg(**KW), data["ref_ids"],
                               data["ref_lens"], layout="flip"), d=d)
    got = lsh_self_join(SignatureIndex.build(
        LSHConfig(**KW), data["ref_ids"], data["ref_lens"], layout="flip",
        device="cpu"), d=d)
    assert got.n_candidates == {None: 1122, 1: 205}[d]
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.indptr, want.indptr)


# ---------------------------------------------------------------- SW waves
@pytest.mark.parametrize("dp_kernel", ["wavefront", "rowwave"])
def test_wave_scores_match_per_pair(corpus, dp_kernel):
    """Batched waves == the reference's waves over a random pair set; the
    row wave (K7's twin) scores exactly as the wavefront (K3's)."""
    ids, lens = corpus["ids"], corpus["lens"]
    pairs = _random_pairs(corpus, 24, 0)
    want = j_score(ids, lens, pairs, JWave(wave_batch=8))
    got = score_pairs(ids, lens, pairs, WaveConfig(wave_batch=8,
                                                   dp_kernel=dp_kernel),
                      device="cpu")
    _same_scores(got, want)


def test_wave_pid_matches_per_pair(corpus):
    ids, lens = corpus["ids"], corpus["lens"]
    pairs = _random_pairs(corpus, 16, 1)
    cfg = dict(wave_batch=8, with_pid=True)
    _same_scores(score_pairs(ids, lens, pairs, WaveConfig(**cfg),
                             device="cpu"),
                 j_score(ids, lens, pairs, JWave(**cfg)))


def test_wave_all_pad_rows():
    """All-PAD rows (wave padding) score 0 / PID 0 and never poison real
    rows in the same wave, in the PID path and both score sweeps."""
    qs = np.full((3, 12), PAD, np.int8)
    rs = np.full((3, 12), PAD, np.int8)
    seq = np.array([12, 3, 4, 16, 5, 0], np.int8)
    qs[1, :6] = seq
    rs[1, :6] = seq
    got = sw_wave_pid(qs, rs)
    for a, b in zip(got, j_sw_wave_pid(qs, rs)):
        np.testing.assert_array_equal(a, b)
    assert got[2][0] == got[2][2] == 0
    for dp in ("wavefront", "rowwave"):
        np.testing.assert_array_equal(
            dp_scores_block(torch.from_numpy(qs), torch.from_numpy(rs),
                            dp_kernel=dp).numpy(), [0, got[2][1], 0])


@pytest.mark.parametrize("x", [None, 10])
def test_prefilter_survivors_bitexact_rejected_lower_bound(corpus, x):
    ids, lens = corpus["ids"], corpus["lens"]
    pairs = _random_pairs(corpus, 48, 5)
    cfg = dict(wave_batch=8, prefilter=True, prefilter_min=40, xdrop=x)
    pre = score_pairs(ids, lens, pairs, WaveConfig(**cfg), device="cpu")
    _same_scores(pre, j_score(ids, lens, pairs, JWave(**cfg)))
    full = score_pairs(ids, lens, pairs, WaveConfig(wave_batch=8),
                       device="cpu")
    assert (pre.ungapped <= full.scores).all()
    np.testing.assert_array_equal(pre.scores[pre.kept],
                                  full.scores[pre.kept])
    np.testing.assert_array_equal(pre.scores[~pre.kept],
                                  pre.ungapped[~pre.kept])


def test_host_gather_and_ring_depths_agree(corpus):
    """Every drain-ring depth — 0 drains each wave as it is issued — gives
    the default ring's scores."""
    ids, lens = corpus["ids"], corpus["lens"]
    pairs = _random_pairs(corpus, 24, 7)
    base = score_pairs(ids, lens, pairs, WaveConfig(prefilter=True),
                       device="cpu")
    for cfg in (WaveConfig(prefilter=True, inflight=0),
                WaveConfig(prefilter=True, inflight=1),
                WaveConfig(prefilter=True, inflight=8)):
        _same_scores(score_pairs(ids, lens, pairs, cfg, device="cpu"), base)


# ---------------------------------------------------------------- clustering
def test_union_find_components():
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 40, (25, 2))
    np.testing.assert_array_equal(union_find(40, edges),
                                  j_union_find(40, edges))
    labels = union_find(6, np.array([[0, 1], [1, 2], [4, 5]]))
    np.testing.assert_array_equal(labels, [0, 0, 0, 3, 4, 4])
    forest = FamilyForest(30)               # grown in two steps
    forest.union_edges(edges[edges.max(axis=1) < 30])
    forest.grow(40)
    forest.union_edges(edges[edges.max(axis=1) >= 30])
    np.testing.assert_array_equal(forest.labels(), union_find(40, edges))


def test_cluster_families_thresholds():
    pairs = np.array([[0, 1], [2, 3], [4, 5]], np.int32)
    fams = cluster_families(6, pairs, np.array([90.0, 30.0, np.nan]),
                            min_pid=50.0)
    assert fams.n_families == 1
    np.testing.assert_array_equal(fams.families[0], [0, 1])
    np.testing.assert_array_equal(fams.edge_mask, [True, False, False])


# ---------------------------------------------------------------- end to end
def _same_result(got, want):
    np.testing.assert_array_equal(got.pairs, want.pairs)
    _same_scores(got.scored, want.scored)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.families.edge_mask,
                                  want.families.edge_mask)


def test_all_pairs_search_end_to_end(corpus):
    """The default (PID) route, and the kernel route of the H100 smoke
    run (splitmix keys, no Hamming filter, prefilter, score threshold)."""
    ids, lens = corpus["ids"], corpus["lens"]
    got = all_pairs_search(ids, lens, AllPairsConfig(lsh=LSHConfig(**KW),
                                                     min_pid=60.0),
                           device="cpu")
    _same_result(got, j_search(ids, lens, JAllPairs(lsh=JCfg(**KW),
                                                    min_pid=60.0)))
    for fam in got.families.families:
        assert len(set(corpus["labels"][fam])) == 1
    kw = dict(KW, scheme="splitmix")
    wave = dict(prefilter=True, prefilter_min=30)
    got = all_pairs_search(ids, lens, AllPairsConfig(
        lsh=LSHConfig(**kw), hamming_filter=False, wave=WaveConfig(**wave)),
        device="cpu")
    _same_result(got, j_search(ids, lens, JAllPairs(
        lsh=JCfg(**kw), hamming_filter=False, wave=JWave(**wave))))
    assert got.join.n_candidates > 0 and got.scored.kept.any()


def test_all_pairs_search_reuses_index(corpus, indexes):
    res = all_pairs_search(corpus["ids"], corpus["lens"],
                           AllPairsConfig(lsh=LSHConfig(**KW)),
                           index=indexes[1])
    assert res.index is indexes[1]
    with pytest.raises(ValueError, match="corpus"):
        all_pairs_search(corpus["ids"][:4], corpus["lens"][:4],
                         AllPairsConfig(lsh=LSHConfig(**KW)),
                         index=indexes[1])


def test_ingest_labels_equal_scratch(corpus):
    """index.add + delta join + delta scoring + forest union == a
    from-scratch all_pairs_search of the grown corpus (and the
    reference's labels), on the fused-prefilter route."""
    ids, lens = corpus["ids"], corpus["lens"]
    base = len(lens) - 12
    cfg = AllPairsConfig(lsh=LSHConfig(**KW), hamming_filter=False,
                         fuse_prefilter=True,
                         wave=WaveConfig(prefilter_min=30))
    res = all_pairs_search(ids[:base], lens[:base], cfg, device="cpu")
    ing = all_pairs_ingest(ids, lens, base, cfg, index=res.index,
                           forest=forest_from_result(res))
    scratch = all_pairs_search(ids, lens, cfg, device="cpu")
    np.testing.assert_array_equal(ing.labels, scratch.labels)
    np.testing.assert_array_equal(ing.labels, j_search(ids, lens, JAllPairs(
        lsh=JCfg(**KW), hamming_filter=False, fuse_prefilter=True,
        wave=JWave(prefilter_min=30))).labels)
    assert ing.join.n_candidates > 0
    with pytest.raises(ValueError, match="forest"):
        all_pairs_ingest(ids, lens, base, cfg, index=res.index,
                         forest=FamilyForest(3))
