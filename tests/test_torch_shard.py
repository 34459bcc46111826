"""The port's bucket-sharded serving (``repro_torch.index.shard``) held
against the JAX reference on the CPU: the ring's top-k against the
reference's ``topk_probe`` and its ``ShardedIndex`` (one-device mesh, in
process; four forced host devices in a subprocess), for n_shards in
{1, 2, 4} and both layouts, through delta refreshes (a bucket that
straddles base and delta included), auto-compaction of a large delta,
serving-side and index-side compaction, and the engine across a live
refresh. The partition's entry signatures and padded slabs are compared
array for array.

Every compared value is an integer or a bool: the tolerance is exact
equality."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from repro.core.pipeline import LSHConfig as JCfg
from repro.index import ShardedIndex as JSharded
from repro.index.partition import pad_slabs_pow2 as j_pad_slabs_pow2
from repro.index.service import topk_probe as j_topk_probe
from repro.index.store import SignatureIndex as JIndex

from repro_torch.core.pipeline import LSHConfig, ScalLoPS
from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                        make_protein_sets)
from repro_torch.index import (QueryEngine, ServingConfig, ShardedIndex,
                               SignatureIndex, topk_probe)
from repro_torch.index.partition import pad_slabs_pow2
from repro_torch.util import i32_to_u32, u32_to_i32

ROOT = Path(__file__).resolve().parents[1]
KW = dict(k=3, T=13, f=32, d=1)
CFG = LSHConfig(**KW)
# base rows, then delta segments of STEP rows: every index either package
# builds has BASE rows and grows by STEP rows at a time, so the reference
# compiles job 1 for two shapes only
BASE, STEP = 100, 30
K = 6


@pytest.fixture(scope="module")
def data():
    return make_protein_sets(SyntheticProteinConfig(
        n_refs=160, n_homolog_queries=16, n_decoy_queries=16,
        ref_len_mean=90, ref_len_std=12, sub_rates=(0.04, 0.1), seed=51))


@pytest.fixture(scope="module")
def q_sigs(data):
    """Port signatures of the 32 queries (int32 bit patterns) and the same
    words as uint32 numpy, the reference's input."""
    q = ScalLoPS(CFG, device="cpu").signatures(data["query_ids"],
                                               data["query_lens"])
    return q, i32_to_u32(q)


def _pair(data, rows, **kw):
    """The same rows indexed by both packages."""
    ids, lens = data["ref_ids"][rows], data["ref_lens"][rows]
    return (JIndex.build(JCfg(**KW), ids, lens, **kw),
            SignatureIndex.build(CFG, ids, lens, device="cpu", **kw))


def _add(pair, data, start):
    """Grow both indexes by the STEP rows from ``start``."""
    rows = slice(start, start + STEP)
    for idx in pair:
        idx.add(data["ref_ids"][rows], data["ref_lens"][rows])


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _same(got, want):
    """(ids, dists, cap, truncated) of the port == the reference's."""
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert (got[2], got[3]) == (want[2], bool(want[3]))


def _check(jidx, sh, q_sigs, *, cap, B=32, j_sh=None):
    """The port's ring == the reference's topk_probe (and its one-device
    ShardedIndex when given) == the port's topk_probe."""
    qt, qn = q_sigs
    got = sh.topk(qt[:B], k=K, cap=cap)
    _same(got, j_topk_probe(jidx, qn[:B], k=K, cap=cap))
    t = topk_probe(sh.index, qt[:B], k=K, cap=cap)
    _same(got, (t[0].numpy(), t[1].numpy(), t[2], t[3]))
    if j_sh is not None:
        _same(got, j_sh.topk(qn[:B], k=K, cap=cap))
    return got


# ---------------------------------------------------------------- partition
@pytest.mark.parametrize("layout", ["band", "flip"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_entry_sigs_and_padded_slabs_match_the_reference(data, layout, n):
    j, t = _pair(data, slice(0, BASE), layout=layout)
    pj, pt = j.partition(n), t.partition(n)
    ej, et = pj.host_entry_sigs(), pt.host_entry_sigs()
    assert et.dtype == np.uint32 and et.shape == ej.shape
    np.testing.assert_array_equal(et, ej)
    # what the ring uploads (ShardedIndex._put) is these rows
    np.testing.assert_array_equal(et, np.asarray(pj.device_entry_sigs()))
    for a, b in zip(pad_slabs_pow2(*pt.host_slabs(), et),
                    j_pad_slabs_pow2(*pj.host_slabs(), ej)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # without entry signatures the padding returns the three slabs
    assert len(pad_slabs_pow2(*pt.host_slabs())) == 3


def test_partition_without_sigs_has_no_entry_sigs(data):
    from repro_torch.index.partition import BucketPartition
    t = SignatureIndex.build(CFG, data["ref_ids"][:40], data["ref_lens"][:40],
                             device="cpu")
    t._ensure_built()
    with pytest.raises(ValueError, match="without sigs"):
        BucketPartition(t._csr_np, 2).host_entry_sigs()


# ------------------------------------------------------------ the ring
@pytest.mark.parametrize("layout", ["band", "flip"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_matches_reference_through_refresh_and_compaction(
        data, q_sigs, layout, n):
    """Base placement, a two-segment delta refresh, serving-side
    compaction and an index-side compaction (generation bump): every
    top-k, final cap and truncated flag equals the reference's
    topk_probe, with a ragged batch (29 % n != 0) and a cap of 1 that
    makes grow-and-retry fire."""
    pair = _pair(data, slice(0, BASE), layout=layout)
    jidx, tidx = pair
    sh = ShardedIndex(tidx, ["cpu"] * n)
    assert sh.n_shards == n and sh.epoch == (1, 1)
    grown = _check(jidx, sh, q_sigs, cap=1)
    assert grown[2] > 1                     # grow-and-retry fired
    _check(jidx, sh, q_sigs, cap=32, B=29)
    _add(pair, data, BASE)
    _add(pair, data, BASE + STEP)
    got = _check(jidx, sh, q_sigs, cap=32)
    assert sh._delta is not None and sh.epoch == (1, 3)
    _check(jidx, sh, q_sigs, cap=1, B=29)
    sh.compact()
    assert sh._delta is None and sh.epoch == (3, 3)
    after = _check(jidx, sh, q_sigs, cap=32)
    np.testing.assert_array_equal(after[0], got[0])
    np.testing.assert_array_equal(after[1], got[1])
    _add(pair, data, 0)
    for idx in pair:
        idx.compact()
    gen = sh._gen
    _check(jidx, sh, q_sigs, cap=32)
    assert sh._gen == gen + 1 and sh._delta is None


def test_ring_matches_reference_sharded_index_one_device(data, q_sigs):
    """The port's ring == the reference's ShardedIndex on a one-device
    mesh, base and base + delta."""
    pair = _pair(data, slice(0, BASE))
    jidx, tidx = pair
    j_sh = JSharded(jidx, _mesh1())
    for n in (1, 4):
        _check(jidx, ShardedIndex(tidx, ["cpu"] * n), q_sigs, cap=1,
               j_sh=j_sh)
    sh = ShardedIndex(tidx, ["cpu"] * 2)
    _add(pair, data, BASE)
    _check(jidx, sh, q_sigs, cap=32, j_sh=j_sh)
    assert sh._delta is not None and j_sh._delta is not None
    assert sh.epoch == j_sh.epoch


def test_bucket_straddling_base_and_delta_sums_its_sizes(data):
    """Copies of base rows land in the very buckets of their originals, so
    those buckets are split across the base and delta slabs. Served their
    own signatures at cap 1, every query's bucket holds at least one base
    and one delta entry: the summed size overflows the cap and grows it,
    as the merged table's probe does."""
    pair = _pair(data, slice(0, BASE))
    jidx, tidx = pair
    sh = ShardedIndex(tidx, ["cpu"] * 4)
    _add(pair, data, 0)
    own = (u32_to_i32(tidx.sigs[:29]), tidx.sigs[:29])
    got = _check(jidx, sh, own, cap=1, B=29)
    assert sh._delta is not None and got[2] >= 2
    # each copy is its original's twin: both ids come back at distance 0
    for r in range(29):
        if tidx.valid[r]:
            assert {r, BASE + r} <= set(got[0][r][got[1][r] == 0].tolist())


def test_refresh_auto_compacts_large_delta(data, q_sigs):
    """A delta that outgrows the base placement is folded in."""
    pair = _pair(data, slice(0, BASE))
    jidx, tidx = pair
    sh = ShardedIndex(tidx, ["cpu"] * 2)
    sh.topk(q_sigs[0], k=K, cap=32)
    for start in range(BASE, BASE + 4 * STEP, STEP):   # 120 rows > 100
        _add(pair, data, start % len(data["ref_lens"]))
    _check(jidx, sh, q_sigs, cap=32)
    assert sh._delta is None, "oversized delta should have re-placed"


def test_flip_layout_sharded_and_refreshed(data, q_sigs):
    pair = _pair(data, slice(0, BASE), layout="flip")
    jidx, tidx = pair
    sh = ShardedIndex(tidx, ["cpu"] * 4)
    _check(jidx, sh, q_sigs, cap=64)
    _add(pair, data, BASE)
    _check(jidx, sh, q_sigs, cap=64)
    assert sh._delta is not None


def test_ring_across_devices_moves_blocks_between_stacks(data, q_sigs):
    """Shards on two devices (two stacks; blocks cross between them with
    ``.to()``) give the one-stack answer."""
    pair = _pair(data, slice(0, BASE))
    jidx, tidx = pair
    for devices in (["cpu:0", "cpu:1", "cpu:0", "cpu:1"],
                    ["cpu:1", "cpu:0", "cpu:0"]):
        sh = ShardedIndex(tidx, devices)
        assert len(sh._groups) == 2
        _check(jidx, sh, q_sigs, cap=1, B=29)
    _add(pair, data, BASE)
    _check(jidx, sh, q_sigs, cap=32)


def test_refresh_on_another_thread_during_a_probe(data, q_sigs,
                                                 monkeypatch):
    """A refresh that lands while a ring runs (from a second thread, here
    inside the ring's first collect) leaves that call on the placement it
    started with; the next call serves the refreshed one. Each equals the
    reference's topk_probe at its epoch."""
    import threading

    from repro_torch.index import shard as shard_mod
    pair = _pair(data, slice(0, BASE))
    jidx, tidx = pair
    sh = ShardedIndex(tidx, ["cpu"] * 2)
    qt, qn = q_sigs
    before = j_topk_probe(jidx, qn, k=K, cap=32)
    real, errors, fired = shard_mod._collect, [], []

    def grow():
        try:
            _add(pair, data, BASE)
            sh.refresh()
        except BaseException as e:      # surfaced in the probing thread
            errors.append(e)

    def collect(*args, **kw):
        if not fired:
            fired.append(True)
            t = threading.Thread(target=grow)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive() and not errors, errors
        return real(*args, **kw)

    monkeypatch.setattr(shard_mod, "_collect", collect)
    _same(sh.topk(qt, k=K, cap=32), before)
    assert fired and sh._delta is not None and sh.epoch == (1, 2)
    _check(jidx, sh, q_sigs, cap=32)


def test_engine_serves_across_live_refresh(data):
    """QueryEngine(sharded=) keeps serving while the index grows; the
    epoch shows in stats, the answers equal the unsharded probe engine's
    and the reference's engine, before and after compaction."""
    from repro.index import QueryEngine as JEngine, ServingConfig as JScfg
    pair = _pair(data, slice(0, BASE))
    jidx, tidx = pair
    scfg = ServingConfig(k=5, mode="probe")
    eng = QueryEngine(tidx, scfg, sharded=ShardedIndex(tidx, ["cpu"] * 2))
    plain = QueryEngine(tidx, scfg)
    jeng = JEngine(jidx, JScfg(k=5, mode="probe"))
    qi, ql = data["query_ids"][:8], data["query_lens"][:8]
    eng.query_batch(qi, ql)
    assert eng.stats()["index_epoch"] == 1
    _add(pair, data, BASE)
    a = eng.query_batch(qi, ql)
    assert eng.stats()["index_epoch"] == 2
    for want in (plain.query_batch(qi, ql), jeng.query_batch(qi, ql)):
        np.testing.assert_array_equal(a[0], np.asarray(want[0]))
        np.testing.assert_array_equal(a[1], np.asarray(want[1]))
    eng.sharded.compact()
    b = eng.query_batch(qi, ql)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_compact_noop_when_already_compact(data):
    """compact() on a single-segment index bumps no generation, so the
    replica re-places once and not again."""
    t = SignatureIndex.build(CFG, data["ref_ids"][:BASE],
                             data["ref_lens"][:BASE], device="cpu")
    t.add(data["ref_ids"][BASE:], data["ref_lens"][BASE:])
    sh = ShardedIndex(t, ["cpu"] * 2)
    t.compact()
    gen = t.generation
    sh.topk(t.sigs[:4], k=3, cap=32)            # uint32 numpy queries
    assert sh._gen == gen
    t.compact()
    assert t.generation == gen and len(t.segments) == 1


def test_empty_batches_and_devices(data, q_sigs):
    t = SignatureIndex.build(CFG, data["ref_ids"][:40], data["ref_lens"][:40],
                             device="cpu")
    sh = ShardedIndex(t)
    assert sh.n_shards == 1 and sh.devices == (torch.device("cpu"),)
    ids, dists, cap, tr = sh.topk(q_sigs[0][:0], k=K, cap=8)
    assert ids.shape == dists.shape == (0, K) and (cap, tr) == (8, False)
    with pytest.raises(ValueError, match="at least one device"):
        ShardedIndex(t, [])



def test_sharded_index_roundtrip_served_by_four_shards(tmp_path, data,
                                                      q_sigs):
    """An index built for 4 shards (its fingerprint says so, as the
    reference's does) saves, loads and serves through a 4-shard ring with
    the reference's answers."""
    j, t = _pair(data, slice(0, BASE), n_shards=4)
    assert t.fingerprint == j.fingerprint and t.n_shards == 4
    t.save(tmp_path / "sharded.npz")
    loaded = SignatureIndex.load(tmp_path / "sharded.npz",
                                 expected_cfg=CFG, device="cpu")
    assert loaded.n_shards == 4 and loaded.fingerprint == t.fingerprint
    _check(j, ShardedIndex(loaded, ["cpu"] * loaded.n_shards), q_sigs,
           cap=32)

# ------------------------------------------------------- forced 4 devices
_SUBPROCESS = """
import sys
import numpy as np
import jax
assert jax.device_count() == 4, jax.devices()
from jax.sharding import Mesh

from repro.core import LSHConfig
from repro.data import SyntheticProteinConfig, make_protein_sets
from repro.index import ShardedIndex, SignatureIndex

data = make_protein_sets(SyntheticProteinConfig(
    n_refs=160, n_homolog_queries=16, n_decoy_queries=16,
    ref_len_mean=90, ref_len_std=12, sub_rates=(0.04, 0.1), seed=51))
q = np.load(sys.argv[2])
out = {}
for layout in ("band", "flip"):
    idx = SignatureIndex.build(LSHConfig(k=3, T=13, f=32, d=1),
                               data["ref_ids"][:100], data["ref_lens"][:100],
                               layout=layout)
    sh = ShardedIndex(idx, Mesh(np.array(jax.devices()[:4]), ("data",)))
    for step in ("base", "delta"):
        if step == "delta":
            idx.add(data["ref_ids"][100:], data["ref_lens"][100:])
        for cap in (4,):
            nid, nd, c, tr = sh.topk(q[:29], k=6, cap=cap)
            key = f"{layout}_{step}_{cap}"
            out[key + "_ids"], out[key + "_dists"] = nid, nd
            out[key + "_cap"] = np.array([c, int(tr)])
    assert sh._delta is not None
np.savez(sys.argv[1], **out)
print("RING4-DONE")
"""


def test_port_four_shards_match_reference_four_device_ring(tmp_path, data,
                                                           q_sigs):
    """The reference's real 4-device ppermute ring (XLA-forced host
    devices, in a subprocess), base and after a delta refresh, == the
    port's 4 shards, array for array."""
    qfile, out = tmp_path / "q.npy", tmp_path / "ring4.npz"
    np.save(qfile, q_sigs[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS, str(out),
                           str(qfile)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and "RING4-DONE" in proc.stdout, proc.stderr
    want = np.load(out)
    for layout in ("band", "flip"):
        t = SignatureIndex.build(CFG, data["ref_ids"][:BASE],
                                 data["ref_lens"][:BASE], layout=layout,
                                 device="cpu")
        sh = ShardedIndex(t, ["cpu"] * 4)
        for step in ("base", "delta"):
            if step == "delta":
                t.add(data["ref_ids"][BASE:], data["ref_lens"][BASE:])
            for cap in (4,):
                key = f"{layout}_{step}_{cap}"
                nid, nd, c, tr = sh.topk(q_sigs[0][:29], k=K, cap=cap)
                np.testing.assert_array_equal(nid, want[key + "_ids"])
                np.testing.assert_array_equal(nd, want[key + "_dists"])
                assert [c, int(tr)] == want[key + "_cap"].tolist(), key
        assert sh._delta is not None
