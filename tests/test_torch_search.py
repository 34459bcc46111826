"""Parity of the port's job 2 with the JAX reference: ``flip_masks``,
``all_pairs_hamming``, the flip, band and dense joins (pair buffers, true
counts and ``truncated``, bit for bit, at d in {0, 1, 2}, with buffers
smaller than the true count so the truncation order is compared too),
``ScalLoPS.search`` with masks and overflow, ``QueryEngine.search_pairs``
(flip, and dense at d in {1, 3}, grown from a small capacity),
and the paper's configs and FASTA I/O. Both packages take the same numpy
inputs; every output is integer and compared exactly. On the CPU the dense
join's kernels K6 and K2 run as their plain twins. The reference's joins
are eager jnp code; they are jitted whole here, so each shape compiles
once instead of op by op."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import hamming as j_ham
from repro.core import join as j_join
from repro.core.pipeline import LSHConfig as JCfg, ScalLoPS as JScalLoPS
from repro.data.synthetic import SyntheticProteinConfig, make_protein_sets
from repro.index.service import QueryEngine as JEngine, \
    ServingConfig as JServing
from repro.index.store import SignatureIndex as JIndex

from repro_torch.core import hamming as t_ham
from repro_torch.core import join as t_join
from repro_torch.core.pipeline import LSHConfig as TCfg, ScalLoPS as TScalLoPS
from repro_torch.index.service import QueryEngine as TEngine, \
    ServingConfig as TServing
from repro_torch.index.store import SignatureIndex as TIndex
from repro_torch.util import u32_to_i32

CFG = dict(k=3, T=13, f=32, d=1, max_pairs=1 << 14)

_j_flip = jax.jit(j_join.flip_join, static_argnames=("f", "d", "max_pairs"))
_j_band = jax.jit(j_join.band_join,
                  static_argnames=("f", "d", "max_pairs", "bands"))
_j_dense = jax.jit(j_ham.threshold_pairs, static_argnums=(2, 3))


@functools.lru_cache(maxsize=None)
def _j_search_fn(cfg: JCfg, max_pairs: int):
    sl = JScalLoPS(cfg)
    return jax.jit(lambda q, r, qv, rv: sl.search(
        q, r, max_pairs=max_pairs, q_valid=qv, r_valid=rv))


def _j_search(cfg: JCfg, q, r, *, max_pairs=None, q_valid=None,
              r_valid=None):
    """The reference's ``ScalLoPS.search``, jitted per (config, capacity)."""
    return _j_search_fn(cfg, max_pairs or cfg.max_pairs)(
        jnp.asarray(q), jnp.asarray(r), q_valid, r_valid)


def _brute_pairs(q, r, d):
    out = set()
    for i in range(q.shape[0]):
        for j in range(r.shape[0]):
            dist = sum(bin(int(q[i, w]) ^ int(r[j, w])).count("1")
                       for w in range(q.shape[1]))
            if dist <= d:
                out.add((i, j))
    return out


def _same(got, want):
    """Port tensors against reference arrays: the same values and shape."""
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _flip_inputs():
    """The reference test's inputs: 20 refs, queries planted at distance 1
    (query 3) and 2 (query 7) from their refs."""
    rng = np.random.default_rng(4)
    base = rng.integers(0, 2**32, (20, 1), dtype=np.uint32)
    q = base.copy()
    q[3, 0] ^= 1
    q[7, 0] ^= 0b101
    return q, base


def _band_inputs(f):
    """The reference test's inputs: query i has i%4 of its ref's bits
    flipped."""
    rng = np.random.default_rng(5)
    nw = f // 32
    r = rng.integers(0, 2**32, (24, nw), dtype=np.uint32)
    q = r.copy()
    for i in range(q.shape[0]):
        for b in range(i % 4):
            q[i, b % nw] ^= np.uint32(1) << np.uint32((7 * i + b) % 32)
    return q, r


# ------------------------------------------------------------ primitives
@pytest.mark.parametrize("f,d", [(32, 2), (64, 1)])
def test_flip_masks_counts(f, d):
    m = t_join.flip_masks(f, d)
    np.testing.assert_array_equal(m, j_join.flip_masks(f, d))
    assert m.dtype == np.uint32 and m.shape[1] == f // 32
    if (f, d) == (32, 2):
        assert m.shape[0] == 1 + 32 + 32 * 31 // 2   # 529, as in the paper


def test_all_pairs_hamming_blocked_vs_direct():
    rng = np.random.default_rng(2)
    q = rng.integers(0, 2**32, (7, 2), dtype=np.uint32)
    r = rng.integers(0, 2**32, (13, 2), dtype=np.uint32)
    got = t_ham.all_pairs_hamming(u32_to_i32(q), u32_to_i32(r), block=4)
    want = np.zeros((7, 13), np.int32)
    for i in range(7):
        for j in range(13):
            want[i, j] = sum(bin(int(q[i, w]) ^ int(r[j, w])).count("1")
                             for w in range(2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_ham.all_pairs_hamming(
            jnp.asarray(q), jnp.asarray(r), block=4)))


# ------------------------------------------------------------ flip join
@pytest.mark.parametrize("max_pairs", [512, 9])
@pytest.mark.parametrize("d", [0, 1, 2])
def test_flip_join_exact(d, max_pairs):
    q, r = _flip_inputs()
    got = t_join.flip_join(u32_to_i32(q), u32_to_i32(r), f=32, d=d,
                           max_pairs=max_pairs)
    want = _j_flip(jnp.asarray(q), jnp.asarray(r), f=32, d=d,
                  max_pairs=max_pairs)
    _same(got, want)
    truth = _brute_pairs(q, r, d)
    assert int(got[1]) == len(truth)
    if max_pairs >= len(truth):
        assert t_join.pairs_to_set(got[0]) == truth


def test_flip_join_orders_ties_by_reference_id():
    """Several refs share one signature: the stable sort keeps their
    expansion order, so each query's pairs come in ascending ref id, as
    ``jnp.argsort`` (stable) gives them — keys >= 2^31 included."""
    r = np.array([[0x80000001], [5], [0x80000001], [4], [0x80000001],
                  [0x80000000]], np.uint32)
    q = np.array([[0x80000001], [5], [0xFFFFFFFF]], np.uint32)
    for mp in (16, 4):
        got = t_join.flip_join(u32_to_i32(q), u32_to_i32(r), f=32, d=1,
                               max_pairs=mp)
        want = _j_flip(jnp.asarray(q), jnp.asarray(r), f=32, d=1,
                       max_pairs=mp)
        _same(got, want)
    assert got[0][:4, 1].tolist() == [0, 2, 4, 5]


# ------------------------------------------------------------ band join
@pytest.mark.parametrize("f,d,bands", [(32, 0, 1), (32, 1, 2), (32, 2, 3),
                                       (64, 2, 3), (64, 3, 4)])
def test_band_join_exact(f, d, bands):
    q, r = _band_inputs(f)
    got = t_join.band_join(u32_to_i32(q), u32_to_i32(r), f=f, d=d,
                           max_pairs=2048, bands=bands)
    want = _j_band(jnp.asarray(q), jnp.asarray(r), f=f, d=d,
                   max_pairs=2048, bands=bands)
    _same(got, want)
    truth = _brute_pairs(q, r, d)
    assert t_join.pairs_to_set(got[0]) == truth
    assert int(got[1]) == len(truth)
    assert not bool(got[2])


@pytest.mark.parametrize("max_pairs", [4, 12])
def test_band_join_truncation_matches(max_pairs):
    """A band's candidates overrun the per-band capacity: the reference's
    count is taken from the capacity-bounded candidates, and the port's
    undercounts in the same way."""
    q, r = _band_inputs(32)
    got = t_join.band_join(u32_to_i32(q), u32_to_i32(r), f=32, d=2,
                           max_pairs=max_pairs, bands=3)
    want = _j_band(jnp.asarray(q), jnp.asarray(r), f=32, d=2,
                   max_pairs=max_pairs, bands=3)
    _same(got, want)
    assert bool(got[2])


# ------------------------------------------------------------ dense join
@pytest.mark.parametrize("max_pairs", [256, 5, 40])
def test_threshold_pairs_dense(max_pairs):
    """max_pairs above Q*R gives the reference's (Q*R, 3) buffer (its
    ``argsort(~flat)[:max_pairs]``); below the true count the buffer keeps
    the row-major first hits."""
    rng = np.random.default_rng(6)
    r = rng.integers(0, 2**32, (10, 1), dtype=np.uint32)
    q = r.copy()
    q[2, 0] ^= 3
    r[4] = r[1]                       # two refs at distance 0 of query 1
    got = t_ham.threshold_pairs(u32_to_i32(q), u32_to_i32(r), 2, max_pairs)
    want = _j_dense(jnp.asarray(q), jnp.asarray(r), 2, max_pairs)
    _same(got, want)
    assert got[0].shape == (min(max_pairs, 100), 3)
    truth = _brute_pairs(q, r, 2)
    assert int(got[1]) == len(truth)
    if max_pairs >= len(truth):
        assert t_join.pairs_to_set(got[0]) == truth


def test_threshold_pairs_tiles_are_exact(monkeypatch):
    """Emission tiles of one query row each, and of several, give the same
    buffer as one tile."""
    rng = np.random.default_rng(8)
    r = rng.integers(0, 2**32, (40, 1), dtype=np.uint32)
    q = np.concatenate([r[::3], r[1::4]])
    q[::2, 0] ^= 1
    args = (u32_to_i32(q), u32_to_i32(r), 1, 30)
    whole = t_ham.threshold_pairs(*args)
    for budget in (8 * 40, 8 * 40 * 3):
        monkeypatch.setattr(t_ham, "_TILE_BYTES", budget)
        _same(t_ham.threshold_pairs(*args), whole)
    _same(whole, _j_dense(jnp.asarray(q), jnp.asarray(r), 1, 30))


def test_dense_join_launches_k6_once_and_k2_per_tile(monkeypatch):
    """On CUDA operands the dense join counts with one K6 launch and emits
    with one K2 launch per tile of hit rows, and only rows that start
    inside the buffer are emitted. With no card here, the device check
    answers CUDA and the twins stand in for the launchers."""
    from repro_torch.kernels import hamming, ops, ref
    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(hamming, "hamming_count",
                        lambda q, r, *, d: ref.hamming_count_ref(q, r, d))
    monkeypatch.setattr(hamming, "hamming_dist", ref.hamming_dist_ref)
    monkeypatch.setattr(t_ham, "_TILE_BYTES", 8 * 10 * 2)   # 2 rows a tile
    rng = np.random.default_rng(6)
    r = rng.integers(0, 2**32, (10, 1), dtype=np.uint32)
    q = np.concatenate([r[:5], r[:3] ^ np.uint32(1 << 9)])
    for max_pairs, tiles in ((100, 4), (4, 2)):   # 8 hit rows; rows 0-3
        ops.reset_launches()
        got = t_ham.threshold_pairs(u32_to_i32(q), u32_to_i32(r), 1,
                                    max_pairs)
        assert ops.LAUNCHES["hamming_count"] == 1
        assert ops.LAUNCHES["hamming_dist"] == tiles
        _same(got, _j_dense(jnp.asarray(q), jnp.asarray(r), 1, max_pairs))
    ops.reset_launches()


# ------------------------------------------------------------ edge inputs
@pytest.mark.parametrize("method", ["flip", "band", "dense"])
def test_no_hit_inputs_match(method):
    """No pair within d: count 0 and an all -1 buffer, as the reference's."""
    q = np.array([[0x0000FFFF], [0x00FF00FF]], np.uint32)
    r = np.array([[0xFFFF0000], [0xFF00FF00], [0x0F0F0F0F]], np.uint32)
    kw = dict(k=3, T=13, f=32, d=1, join_method=method)
    got = TScalLoPS(TCfg(**kw), device="cpu").search(q, r, max_pairs=8)
    _same(got, _j_search(JCfg(**kw), q, r, max_pairs=8))
    assert int(got.count) == 0 and bool((got.pairs == -1).all())


@pytest.mark.parametrize("nq,nr", [(2, 0), (0, 3)])
def test_empty_side(nq, nr):
    """An empty query or reference set: the reference's flip and band joins
    fail (their clamped gathers have no row to read) and the port refuses
    with a ValueError; the dense join returns an empty buffer in both."""
    q = np.arange(nq, dtype=np.uint32)[:, None]
    r = np.arange(nr, dtype=np.uint32)[:, None]
    for join in (t_join.flip_join, t_join.band_join):
        with pytest.raises(ValueError, match="at least one"):
            join(u32_to_i32(q), u32_to_i32(r), f=32, d=1, max_pairs=4)
    with pytest.raises(TypeError):
        _j_flip(jnp.asarray(q), jnp.asarray(r), f=32, d=1, max_pairs=4)
    got = t_ham.threshold_pairs(u32_to_i32(q), u32_to_i32(r), 1, 4)
    _same(got, _j_dense(jnp.asarray(q), jnp.asarray(r), 1, 4))
    assert got[0].shape == (0, 3)


def test_flip_join_refuses_wide_signatures():
    s = u32_to_i32(np.zeros((2, 2), np.uint32))
    with pytest.raises(ValueError, match="f <= 32"):
        t_join.flip_join(s, s, f=64, d=0, max_pairs=4)


# ------------------------------------------------------------ ScalLoPS.search
@pytest.fixture(scope="module")
def data():
    return make_protein_sets(SyntheticProteinConfig(
        n_refs=96, n_homolog_queries=24, n_decoy_queries=24,
        ref_len_mean=100, ref_len_std=15, sub_rates=(0.03, 0.1), seed=17))


@pytest.fixture(scope="module")
def sigs(data):
    """Query and reference signatures and validity from the port's job 1
    (held equal to the reference's by ``test_torch_core.py``), as numpy."""
    sl = TScalLoPS(TCfg(**CFG), device="cpu")
    out = {}
    for side in ("query", "ref"):
        ids, lens = data[f"{side}_ids"], data[f"{side}_lens"]
        out[side] = sl.signatures(ids, lens).numpy().view(np.uint32)
        out[f"{side}_valid"] = (sl.feature_counts(ids, lens) > 0).numpy()
    return out


def _cfgs(method, **kw):
    cfg = dict(CFG, join_method=method, **kw)
    return TScalLoPS(TCfg(**cfg), device="cpu"), JCfg(**cfg)


@pytest.mark.parametrize("method", ["flip", "band", "dense"])
def test_search_valid_masking_drops_pairs(sigs, method):
    """q_valid/r_valid: pairs touching invalid rows are dropped in place
    and the count is the masked one."""
    t, jc = _cfgs(method)
    q, r = sigs["query"], sigs["ref"]
    full = t.search(q, r)
    _same(full, _j_search(jc, q, r))
    assert not bool(full.overflowed)
    base = t_join.pairs_to_set(full.pairs)
    assert base, "need some pairs for a meaningful mask test"
    qv = np.ones(q.shape[0], bool)
    qv[[a for a, _ in base if a % 2 == 0]] = False
    rv = np.ones(r.shape[0], bool)
    rv[[b for _, b in base if b % 3 == 0]] = False
    res = t.search(q, r, q_valid=qv, r_valid=rv)
    _same(res, _j_search(jc, q, r, q_valid=qv, r_valid=rv))
    want = {(a, b) for a, b in base if qv[a] and rv[b]}
    assert t_join.pairs_to_set(res.pairs) == want
    assert int(res.count) == len(want) and res.count.dtype == torch.int32
    # the paper's own masks: zero-feature sequences
    kw = dict(q_valid=sigs["query_valid"], r_valid=sigs["ref_valid"])
    _same(t.search(q, r, **kw), _j_search(jc, q, r, **kw))


@pytest.mark.parametrize("method", ["flip", "band", "dense"])
def test_search_overflow_flag(sigs, method):
    t, jc = _cfgs(method)
    q, r = sigs["query"], sigs["ref"]
    n = int(t.search(q, r).count)
    assert n > 2
    small = t.search(q, r, max_pairs=2)
    _same(small, _j_search(jc, q, r, max_pairs=2))
    assert bool(small.overflowed)
    # the band join's per-band capacity must hold each band's candidates,
    # which outnumber the pairs
    mp = 2 * n if method != "band" else CFG["max_pairs"]
    grown = t.search(q, r, max_pairs=mp)
    _same(grown, _j_search(jc, q, r, max_pairs=mp))
    assert not bool(grown.overflowed) and int(grown.count) == n


@pytest.mark.parametrize("method", ["flip", "band", "dense"])
def test_search_overflow_flag_all_joins(method):
    """band_join's candidates can truncate before the final count, so the
    count alone can look <= max_pairs while pairs were lost — overflowed
    must still be True (8x8 identical signatures, 64 pairs)."""
    t, jc = _cfgs(method, d=0)
    s = np.full((8, 1), 0x12345678, np.uint32)
    for mp in (16, 256):
        res = t.search(s, s, max_pairs=mp)
        _same(res, _j_search(jc, s, s, max_pairs=mp))
        assert bool(res.overflowed) == (mp == 16)
    assert int(res.count) == 64


def test_engine_search_pairs_grows_capacity(data, sigs):
    """Job 1 on the queries, then the join against the index, doubling the
    capacity from 2 until nothing is truncated: the reference's search at
    the capacity reached, with the paper's masks."""
    cfg = dict(CFG, scheme="java")
    ti = TIndex(TCfg(**cfg), sigs["ref"], sigs["ref_valid"], device="cpu")
    te = TEngine(ti, TServing(k=3))
    res = te.search_pairs(data["query_ids"], data["query_lens"], max_pairs=2)
    assert not bool(res.overflowed)    # grew until nothing truncated
    assert int(res.count) == len(t_join.pairs_to_set(res.pairs))
    mp = res.pairs.shape[0]
    assert mp > 2 and mp & (mp - 1) == 0
    _same(res, _j_search(JCfg(**cfg), sigs["query"], sigs["ref"],
                         max_pairs=mp, q_valid=sigs["query_valid"],
                         r_valid=sigs["ref_valid"]))
    capped = te.search_pairs(data["query_ids"], data["query_lens"],
                             max_pairs=2, max_grow=4)
    assert bool(capped.overflowed) and capped.pairs.shape[0] == 4


@pytest.mark.parametrize("d", [1, 3])
def test_dense_search_pairs_grows_like_the_reference(data, d):
    """A dense-joined index from a capacity of 4: the join retries until
    nothing overflows, and the pair buffer, count and flag are the
    reference's ``search_pairs``, and at d = 1 the flip join's, exactly."""
    ids, lens = data["query_ids"], data["query_lens"]

    def dump(engine):
        res = engine.search_pairs(ids, lens, max_pairs=4)
        return np.asarray(res.pairs), int(res.count), bool(res.overflowed)

    def port(method):
        cfg = TCfg(**dict(CFG, scheme="java", join_method=method, d=d))
        return TEngine(TIndex.build(cfg, data["ref_ids"], data["ref_lens"],
                                    device="cpu"), TServing(k=3))

    te = port("dense")
    got = dump(te)
    assert got[1] > 4 and not got[2]
    assert te.pair_stats()[0]["attempts"] > 1
    jcfg = JCfg(**dict(CFG, scheme="java", join_method="dense", d=d))
    want = dump(JEngine(JIndex.build(jcfg, data["ref_ids"],
                                     data["ref_lens"]), JServing(k=3)))
    _same(got, want)
    if d == 1:
        _same(got, dump(port("flip")))


# ------------------------------------------------------------ configs, FASTA
def test_scallops_configs_match_reference():
    from repro.configs import scallops as j_cfg
    from repro_torch.configs import scallops as t_cfg
    for name in ("quality_config", "perf_config", "optimized_config"):
        assert (dataclasses.asdict(getattr(t_cfg, name)())
                == dataclasses.asdict(getattr(j_cfg, name)()))
    assert t_cfg.DATASETS == j_cfg.DATASETS


def test_fasta_round_trip_matches_reference(tmp_path, data):
    from repro.data import fasta as j_fasta
    from repro_torch.data import fasta as t_fasta
    ids, lens = data["query_ids"][:6], data["query_lens"][:6]
    names = [f"q{i}" for i in range(6)]
    path = tmp_path / "q.fasta"
    t_fasta.write_fasta(path, names, ids, lens)
    text = path.read_text()
    j_fasta.write_fasta(tmp_path / "j.fasta", names, ids, lens)
    assert text == (tmp_path / "j.fasta").read_text()
    path.write_text(text.replace("\n>", "\n\n>").replace(
        ">q1\n", ">q1 extra words\n"))      # blank lines, a description
    assert t_fasta.read_fasta(path) == j_fasta.read_fasta(path)
    n, i, l = t_fasta.load_fasta_encoded(path)
    jn, ji, jl = j_fasta.load_fasta_encoded(path)
    assert n == jn == names
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(l, jl)
    np.testing.assert_array_equal(l, lens)
    np.testing.assert_array_equal(i[:, :ids.shape[1]], ids[:, :i.shape[1]])
