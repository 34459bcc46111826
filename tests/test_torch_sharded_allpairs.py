"""The port's sharded all-pairs path against the JAX reference on the CPU:
``lsh_self_join`` and ``lsh_delta_join`` at n_shards 1, 2 and 4 (band and
flip layouts, uniform and skewed per-shard demand, one device stack and
two), ``score_pairs`` split over 1, 2 and 4 devices, and
``all_pairs_search`` / ``all_pairs_ingest`` with four shards. The cases
mirror ``tests/test_sharding.py`` and the delta-join cases of
``tests/test_lifecycle.py``. The reference's one-device path gives the
same pair arrays for every n_shards; its real multi-device programs (and
the wave counts of its split waves) come from a subprocess under 4
XLA-forced host devices."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.allpairs import AllPairsConfig as JAllPairs
from repro.allpairs import WaveConfig as JWave
from repro.allpairs import all_pairs_ingest as j_ingest
from repro.allpairs import all_pairs_search as j_search
from repro.allpairs import forest_from_result as j_forest
from repro.allpairs import lsh_delta_join as j_delta
from repro.allpairs import lsh_self_join as j_join
from repro.allpairs import score_pairs as j_score
from repro.allpairs.selfjoin import _shard_caps as j_shard_caps
from repro.core import LSHConfig as JCfg
from repro.index import SignatureIndex as JIndex

from repro_torch.allpairs import (AllPairsConfig, WaveConfig,
                                  all_pairs_ingest, all_pairs_search,
                                  forest_from_result, lsh_delta_join,
                                  lsh_self_join, score_pairs)
from repro_torch.allpairs.selfjoin import _shard_caps
from repro_torch.core.pipeline import LSHConfig
from repro_torch.data.synthetic import (FamilyCorpusConfig,
                                        SyntheticProteinConfig,
                                        make_family_corpus,
                                        make_protein_sets)
from repro_torch.index.store import SignatureIndex
from repro_torch.kernels import ops
from repro_torch.util import next_pow2

ROOT = Path(__file__).resolve().parents[1]
KW = dict(k=3, T=13, f=32, d=1)
TWO = ["cpu:0", "cpu:1"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the twins run thousands of small
    torch ops, and with the suite's workers sharing the cores a full
    thread pool each makes them fight for the cores (the K4 twin's
    column loop ran 100x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """tests/test_sharding.py's subprocess corpus (150 refs, seed 41)."""
    return make_protein_sets(SyntheticProteinConfig(
        n_refs=150, n_homolog_queries=16, n_decoy_queries=16,
        ref_len_mean=90, ref_len_std=12, sub_rates=(0.04, 0.1), seed=41))


def _both(ids, lens, **kw):
    return (JIndex.build(JCfg(**KW), ids, lens, **kw),
            SignatureIndex.build(LSHConfig(**KW), ids, lens, device="cpu",
                                 **kw))


@pytest.fixture(scope="module")
def indexes(data):
    return {layout: _both(data["ref_ids"], data["ref_lens"], layout=layout)
            for layout in ("band", "flip")}


def _devices(n, stacks):
    return ["cpu"] * n if stacks == 1 else (TWO * n)[:n]


def _same_join(got, want):
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)


# ---------------------------------------------------------------- self-join
@pytest.mark.parametrize("layout", ["band", "flip"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_selfjoin_sharded_matches_reference(indexes, layout, n):
    """Every shard count, with and without the Hamming filter, on one
    device stack and on two: the reference's arrays."""
    j_idx, t_idx = indexes[layout]
    for d in (None, 1):
        want = j_join(j_idx, d=d)
        _same_join(lsh_self_join(t_idx, d=d, n_shards=n), want)
        if n > 1:
            _same_join(lsh_self_join(t_idx, d=d, n_shards=n,
                                     devices=_devices(n, 2)), want)


def test_selfjoin_counts_k5_per_route(indexes):
    """The fused route is one emission; two device stacks with uniform
    demand one per stack, with skewed demand one per live shard (counted
    on the twin's path through the wrapper's route, ``upper_pairs``
    counts only CUDA launches, so the count here is of the calls)."""
    _, t_idx = indexes["band"]
    caps = _shard_caps(t_idx.partition(4))
    assert len(set(caps[caps > 0].tolist())) > 1      # skewed at n=4
    calls = []
    real = ops.emit_upper_pairs
    try:
        ops.emit_upper_pairs = lambda *a, **k: calls.append(
            a[0].shape) or real(*a, **k)
        lsh_self_join(t_idx, n_shards=4)
        assert len(calls) == int((caps > 0).sum())
        calls.clear()
        lsh_self_join(t_idx, n_shards=1)
        assert len(calls) == 1
    finally:
        ops.emit_upper_pairs = real


def test_selfjoin_uses_index_default_shards(data):
    j2, t2 = _both(data["ref_ids"], data["ref_lens"], n_shards=2)
    assert t2.n_shards == 2
    _same_join(lsh_self_join(t2), j_join(j2))
    _same_join(lsh_self_join(t2), lsh_self_join(t2, n_shards=1))


def test_selfjoin_devices_must_match_shards(indexes):
    with pytest.raises(ValueError, match="one device per partition shard"):
        lsh_self_join(indexes["band"][1], n_shards=4, devices=["cpu"] * 2)


def test_selfjoin_skew_bounded_caps():
    """One degenerate bucket (40 copies of one sequence, on
    tests/test_sharding.py's corpus) inflates one shard's cap only: the
    port's caps are the reference's, skewed, and the pair arrays are
    unchanged on one stack and on two."""
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=120, n_homolog_queries=20, n_decoy_queries=20,
        ref_len_mean=90, ref_len_std=12, sub_rates=(0.04, 0.1), seed=31))
    ids = np.concatenate([data["ref_ids"][:1].repeat(40, axis=0),
                          data["ref_ids"]], axis=0)
    lens = np.concatenate([data["ref_lens"][:1].repeat(40),
                           data["ref_lens"]])
    j_idx, t_idx = _both(ids, lens)
    base = j_join(j_idx)
    for n in (2, 4):
        caps = _shard_caps(t_idx.partition(n))
        np.testing.assert_array_equal(caps, j_shard_caps(j_idx.partition(n)))
        assert len(set(caps.tolist())) > 1, caps
        assert int(caps.sum()) < n * int(caps.max())
        for stacks in (1, 2):
            _same_join(lsh_self_join(t_idx, n_shards=n,
                                     devices=_devices(n, stacks)), base)
    need = int(t_idx.partition(1).pair_totals.max())
    assert next_pow2(need) > need + 1
    lsh_self_join(t_idx, max_grow=need + 1)
    with pytest.raises(RuntimeError, match="max_grow"):
        lsh_self_join(t_idx, max_grow=need - 1)
    need4 = int(t_idx.partition(4).pair_totals.max())
    with pytest.raises(RuntimeError, match="max_grow"):
        lsh_self_join(t_idx, n_shards=4, devices=_devices(4, 2),
                      max_grow=need4 - 1)


def test_selfjoin_uniform_caps(data):
    """Identical rows: one live bucket per band, one live cap — the fused
    route on one stack, one emission per stack on two."""
    ids = np.repeat(data["ref_ids"][:1], 24, axis=0)
    lens = np.repeat(data["ref_lens"][:1], 24)
    j_idx, t_idx = _both(ids, lens)
    caps = _shard_caps(t_idx.partition(4))
    assert len(set(caps[caps > 0].tolist())) == 1
    want = j_join(j_idx)
    assert want.n_candidates == 24 * 23 // 2
    for stacks in (1, 2):
        _same_join(lsh_self_join(t_idx, n_shards=4,
                                 devices=_devices(4, stacks)), want)


def test_shard_caps_quantized_pow2(indexes):
    caps = _shard_caps(indexes["band"][1].partition(4))
    assert all(c == 0 or c == next_pow2(c) for c in caps.tolist())


# ---------------------------------------------------------------- delta join
@pytest.mark.parametrize("d_filter", [None, 1])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_delta_join_union_equals_full(data, n, d_filter):
    """old pairs ∪ delta pairs == the from-scratch self-join of the grown
    corpus, and the delta pairs are the reference's, over two ingest
    rounds, at every shard count (two device stacks at n > 1)."""
    N = len(data["ref_lens"])
    base = N - 40
    j_idx, t_idx = _both(data["ref_ids"][:base], data["ref_lens"][:base])
    old = lsh_self_join(t_idx, d=d_filter, n_shards=n)
    for a, b in zip((base, base + 20), (base + 20, N)):
        j_idx.add(data["ref_ids"][a:b], data["ref_lens"][a:b])
        t_idx.add(data["ref_ids"][a:b], data["ref_lens"][a:b])
    devices = _devices(n, 2) if n > 1 else None
    delta = lsh_delta_join(t_idx, base_size=base, d=d_filter, n_shards=n,
                           devices=devices)
    _same_join(delta, j_delta(j_idx, base_size=base, d=d_filter,
                              n_shards=n))
    assert (delta.pairs[:, 1] >= base).all()
    full = lsh_self_join(SignatureIndex.build(
        LSHConfig(**KW), data["ref_ids"], data["ref_lens"], device="cpu"),
        d=d_filter)
    union = np.concatenate([old.pairs, delta.pairs], axis=0)
    union = union[np.lexsort((union[:, 1], union[:, 0]))]
    np.testing.assert_array_equal(union, full.pairs)
    # the middle boundary, and the segments' stacks cached per
    # (n_shards, device)
    _same_join(lsh_delta_join(t_idx, base_size=base + 20, d=d_filter,
                              n_shards=n, devices=devices),
               j_delta(j_idx, base_size=base + 20, d=d_filter, n_shards=n))
    keys = set(t_idx.segments[-1]._join_stacks)
    assert n in keys and any(isinstance(k, tuple) and k[0] == n
                             for k in keys)


def test_delta_join_flip_layout_sharded(data):
    N = len(data["ref_lens"])
    j_idx, t_idx = _both(data["ref_ids"][:N - 40], data["ref_lens"][:N - 40],
                         layout="flip")
    j_idx.add(data["ref_ids"][N - 40:], data["ref_lens"][N - 40:])
    t_idx.add(data["ref_ids"][N - 40:], data["ref_lens"][N - 40:])
    for d in (None, 1):
        want = j_delta(j_idx, base_size=N - 40, d=d)
        for n in (1, 4):
            _same_join(lsh_delta_join(t_idx, base_size=N - 40, d=d,
                                      n_shards=n), want)


# ------------------------------------------------------------------- waves
def _pairs(n, m, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, m), rng.integers(0, n, m)],
                    axis=1).astype(np.int32)


def _same_scores(a, b, counts=True):
    np.testing.assert_array_equal(a.scores, b.scores)
    for f in ("pid", "aln_len", "ungapped", "kept"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y)
    if counts:
        assert (a.n_waves, a.n_shapes) == (b.n_waves, b.n_shapes)


@pytest.mark.parametrize("kw", [dict(), dict(prefilter=True),
                                dict(prefilter=True, dp_kernel="rowwave"),
                                dict(gap_mode="affine"),
                                dict(with_pid=True, prefilter=True)])
def test_split_waves_score_as_one_device(data, kw):
    """Waves split over 2 and 4 devices (one stack, two stacks): the
    reference's scores, kept and PID; the wave count shrinks by the split
    (the batch is per device), and the PID waves stay whole."""
    ids, lens = data["ref_ids"], data["ref_lens"]
    pairs = _pairs(len(lens), 90, 2)
    kw = dict(kw, wave_batch=8, prefilter_batch=32)
    want = j_score(ids, lens, pairs, JWave(**kw))
    one = score_pairs(ids, lens, pairs, WaveConfig(**kw), device="cpu")
    _same_scores(one, want)
    for k in (2, 4):
        for stacks in (1, 2):
            got = score_pairs(ids, lens, pairs, WaveConfig(**kw),
                              devices=_devices(k, stacks))
            _same_scores(got, want, counts=False)
            if not kw.get("with_pid") and not kw.get("prefilter"):
                assert got.n_waves < want.n_waves


def test_n_devices_resolves_to_one_device_on_the_cpu(data):
    """``WaveConfig.n_devices`` names cards; on the CPU it is one device,
    as the reference clamps to its device count (1 in this process)."""
    ids, lens = data["ref_ids"], data["ref_lens"]
    pairs = _pairs(len(lens), 40, 3)
    want = j_score(ids, lens, pairs, JWave(wave_batch=8, n_devices=4,
                                           prefilter=True))
    got = score_pairs(ids, lens, pairs, WaveConfig(
        wave_batch=8, n_devices=4, prefilter=True), device="cpu")
    _same_scores(got, want)


# ------------------------------------------------------- search and ingest
@pytest.fixture(scope="module")
def families():
    return make_family_corpus(FamilyCorpusConfig(
        n_families=8, family_size=3, n_singletons=24, len_mean=56,
        len_std=4, sub_rate=0.04, seed=5))


def test_all_pairs_search_and_ingest_four_shards(families):
    """n_shards=4 on four device entries (two stacks), score-only waves
    (the PID route is the CLI test's): the reference's pairs, scores and
    labels, for the batch run and for an ingest."""
    ids, lens = families["ids"], families["lens"]
    jw = JWave(with_pid=False, prefilter=True)
    tw = WaveConfig(with_pid=False, prefilter=True)
    jcfg = JAllPairs(lsh=JCfg(**KW), wave=jw, n_shards=4)
    tcfg = AllPairsConfig(lsh=LSHConfig(**KW), wave=tw, n_shards=4,
                          devices=tuple(_devices(4, 2)))
    want = j_search(ids, lens, jcfg)
    got = all_pairs_search(ids, lens, tcfg)
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.scored.scores, want.scored.scores)
    np.testing.assert_array_equal(got.labels, want.labels)
    base = len(lens) - 12
    jb = j_search(ids[:base], lens[:base], jcfg)
    tb = all_pairs_search(ids[:base], lens[:base], tcfg)
    jing = j_ingest(ids, lens, base, jcfg, index=jb.index,
                    forest=j_forest(jb))
    ting = all_pairs_ingest(ids, lens, base, tcfg, index=tb.index,
                            forest=forest_from_result(tb))
    np.testing.assert_array_equal(ting.join.pairs, jing.join.pairs)
    np.testing.assert_array_equal(ting.labels, jing.labels)
    np.testing.assert_array_equal(ting.labels, want.labels)


# --------------------------------------------- the reference's 4 devices
_SUBPROCESS = """
import sys
import numpy as np
import jax
assert jax.device_count() == 4, jax.devices()
from repro.allpairs import WaveConfig, lsh_delta_join, lsh_self_join, \\
    score_pairs
from repro.core import LSHConfig
from repro.data import SyntheticProteinConfig, make_protein_sets
from repro.index import SignatureIndex

data = make_protein_sets(SyntheticProteinConfig(
    n_refs=150, n_homolog_queries=16, n_decoy_queries=16,
    ref_len_mean=90, ref_len_std=12, sub_rates=(0.04, 0.1), seed=41))
cfg = LSHConfig(k=3, T=13, f=32, d=1)
pairs = np.load(sys.argv[2])
out = {}
idx = SignatureIndex.build(cfg, data["ref_ids"][:120], data["ref_lens"][:120])
for n in (2, 4):
    out[f"self_{n}"] = lsh_self_join(idx, d=cfg.d, n_shards=n).pairs
idx.add(data["ref_ids"][120:], data["ref_lens"][120:])
out["grown_4"] = lsh_self_join(idx, n_shards=4).pairs
out["delta_4"] = lsh_delta_join(idx, base_size=120, d=cfg.d,
                                n_shards=4).pairs
ids, lens = data["ref_ids"], data["ref_lens"]
for n in (2, 4):
    for pre in (False, True):
        s = score_pairs(ids, lens, pairs, WaveConfig(
            wave_batch=8, prefilter_batch=32, prefilter=pre, n_devices=n))
        key = f"waves_{n}_{int(pre)}"
        out[key + "_scores"] = s.scores
        out[key + "_counts"] = np.array([s.n_waves, s.n_shapes])
        if pre:
            out[key + "_kept"] = s.kept
np.savez(sys.argv[1], **out)
print("SHARDED4-DONE")
"""


@pytest.mark.slow
def test_port_matches_reference_four_device_programs(data, tmp_path):
    """The reference's shard_map emission and its SPMD-split waves on 4
    XLA-forced host devices (a subprocess) == the port's shards and split
    waves: self-join and, after an add(), the grown self-join and the
    delta join; scores, kept, n_waves and n_shapes of
    waves split over 2 and 4 devices (one device is the in-process
    case)."""
    pairs = _pairs(150, 48, 2)
    pfile, out = tmp_path / "pairs.npy", tmp_path / "sharded4.npz"
    np.save(pfile, pairs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS, str(out),
                           str(pfile)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and "SHARDED4-DONE" in proc.stdout, \
        proc.stderr[-3000:]
    want = np.load(out)
    t = SignatureIndex.build(LSHConfig(**KW), data["ref_ids"][:120],
                             data["ref_lens"][:120], device="cpu")
    for n in (2, 4):
        np.testing.assert_array_equal(
            lsh_self_join(t, d=1, n_shards=n, devices=_devices(n, 2)).pairs,
            want[f"self_{n}"])
    t.add(data["ref_ids"][120:], data["ref_lens"][120:])
    np.testing.assert_array_equal(lsh_self_join(t, n_shards=4).pairs,
                                  want["grown_4"])
    np.testing.assert_array_equal(
        lsh_delta_join(t, base_size=120, d=1, n_shards=4,
                       devices=_devices(4, 2)).pairs, want["delta_4"])
    ids, lens = data["ref_ids"], data["ref_lens"]
    for n in (2, 4):
        for pre in (False, True):
            key = f"waves_{n}_{int(pre)}"
            for stacks in (1, 2):
                s = score_pairs(ids, lens, pairs, WaveConfig(
                    wave_batch=8, prefilter_batch=32, prefilter=pre),
                    devices=_devices(n, stacks))
                np.testing.assert_array_equal(s.scores, want[key + "_scores"])
                assert [s.n_waves, s.n_shapes] == want[key + "_counts"
                                                       ].tolist(), key
                if pre:
                    np.testing.assert_array_equal(s.kept,
                                                  want[key + "_kept"])
