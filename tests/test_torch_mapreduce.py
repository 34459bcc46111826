"""The port's MapReduce engine (``repro_torch.core.mapreduce``) against
the JAX reference (``repro.core.mapreduce``) on the CPU: reduce, salting,
the shuffle, the distributed flip join and the ring sweep, array for
array. The reference's one-device programs run in process; its real 2-
and 4-device programs (``shard_map`` + ``all_to_all`` / ``ppermute``)
run in a subprocess under XLA-forced host devices, as
``tests/test_mapreduce.py`` runs them. The port's shards are a list of
torch devices: ``["cpu"] * n`` stacks them on one device, ``"cpu:0"`` /
``"cpu:1"`` makes two stacks whose blocks cross with ``.to()``."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import encode_batch
from repro.core.alphabet import AMINO_ACIDS
from repro.core.join import flip_join as j_flip_join
from repro.core.join import pairs_to_set
from repro.core.mapreduce import MapReduceConfig as JConfig
from repro.core.mapreduce import distributed_flip_join as j_dfj
from repro.core.mapreduce import reduce_join as j_reduce
from repro.core.mapreduce import ring_sweep as j_ring
from repro.core.mapreduce import salt_hot_keys as j_salt
from repro.core.mapreduce import shuffle_records as j_shuffle
from repro.core.simhash import signatures_table
from repro.util import shard_map_compat

from repro_torch.core import mapreduce as mr
from repro_torch.kernels import ops
from repro_torch.util import group_devices, u32_to_i32

ROOT = Path(__file__).resolve().parents[1]
EMPTY = 0xFFFFFFFF


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


def _t(a):
    """numpy uint32 keys -> the port's int64 keys."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def sigs():
    """test_mapreduce.py's corpus: 32 refs, 8 queries cut from them and
    24 unrelated ones, f=32 signatures (numpy uint32)."""
    rng = np.random.default_rng(0)
    refs = ["".join(rng.choice(list(AMINO_ACIDS), 60)) for _ in range(32)]
    qrys = [r[:55] for r in refs[:8]] + [
        "".join(rng.choice(list(AMINO_ACIDS), 60)) for _ in range(24)]
    rids, rlen = encode_batch(refs, 64)
    qids, qlen = encode_batch(qrys, 64)
    return (np.asarray(signatures_table(qids, qlen, k=3, T=13, f=32)),
            np.asarray(signatures_table(rids, rlen, k=3, T=13, f=32)))


# ------------------------------------------------------------------ reduce
def test_reduce_join_cross_product():
    keys = np.uint32([7, 7, 7, 7, 7, 9, 9, 5, EMPTY])
    ids = np.int32([10, 20, 11, 21, 22, 12, 23, 24, -1])
    isq = np.int32([1, 0, 1, 0, 0, 1, 0, 0, 0])
    want, wtot = j_reduce(jnp.asarray(keys), jnp.stack(
        [jnp.asarray(ids), jnp.asarray(isq)], -1), max_pairs=32)
    got, tot = mr.reduce_join(_t(keys), torch.from_numpy(
        np.stack([ids, isq], -1)), max_pairs=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tot) == int(wtot) == 7
    assert {(int(a), int(b)) for a, b in got.numpy() if a >= 0} == {
        (10, 20), (10, 21), (10, 22), (11, 20), (11, 21), (11, 22),
        (12, 23)}


@pytest.mark.parametrize("max_pairs", [5, 16, 40])
def test_reduce_join_overflow_reports_true_total(max_pairs):
    """The true total past the buffer, and the same surviving slots as
    the reference (4 queries x 4 refs in one bucket, a second bucket
    behind it, records interleaved)."""
    keys = np.uint32([3, 3, 8, 3, 3, 8, 3, 3, 3, 3])
    ids = np.int32([0, 100, 50, 1, 101, 60, 2, 3, 102, 103])
    isq = np.int32([1, 0, 1, 1, 0, 0, 1, 1, 0, 0])
    want, wtot = j_reduce(jnp.asarray(keys), jnp.stack(
        [jnp.asarray(ids), jnp.asarray(isq)], -1), max_pairs=max_pairs)
    got, tot = mr.reduce_join(_t(keys), torch.from_numpy(
        np.stack([ids, isq], -1)), max_pairs=max_pairs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tot) == int(wtot) == 17
    assert (got.numpy()[:, 0] >= 0).sum() == min(max_pairs, 17)


def test_reduce_join_stacked_shards_equal_one_at_a_time():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 6, (3, 40)).astype(np.uint32)
    keys[:, -3:] = EMPTY
    pay = np.stack([rng.integers(0, 99, (3, 40)),
                    rng.integers(0, 2, (3, 40))], -1).astype(np.int32)
    got, tot = mr.reduce_join(_t(keys), torch.from_numpy(pay), max_pairs=64)
    for s in range(3):
        want, wtot = j_reduce(jnp.asarray(keys[s]), jnp.asarray(pay[s]),
                              max_pairs=64)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))
        assert int(tot[s]) == int(wtot)


# ------------------------------------------------------------------ salting
@pytest.mark.parametrize("thr,n_salt", [(4, 4), (1, 3), (9, 2)])
def test_salting_matches_reference(thr, n_salt):
    keys = np.uint32([42] * 10 + [7, 8, 7, 0xFF000000, 0xFF000000])
    isq = np.asarray([True, True] + [False] * 13)
    want, whot = j_salt(jnp.asarray(keys), hot_threshold=thr,
                        n_salt=n_salt, is_query=jnp.asarray(isq),
                        replicate_queries=False)
    got, hot = mr.salt_hot_keys(_t(keys), hot_threshold=thr, n_salt=n_salt,
                                is_query=torch.from_numpy(isq))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(hot.numpy(), np.asarray(whot))
    if thr == 4:        # the reference test's own assertions
        assert got[0] == 42 and got[1] == 42
        assert (got[2:10] != 42).all()
        assert got[10] == 7 and got[11] == 8
        assert len(set(got[2:10].tolist())) <= 4


# ------------------------------------------------------------------ shuffle
def _j_shuffle_1(keys, pay, capacity):
    """The reference's shuffle on a one-device mesh."""
    mesh = jax.make_mesh((1,), ("data",))
    fn = shard_map_compat(
        lambda k, p: (lambda a, b, c: (a, b, c[None]))(*j_shuffle(
            k, p, axis_name="data", n_shards=1, capacity=capacity)),
        mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data")))
    return [np.asarray(x) for x in jax.jit(fn)(jnp.asarray(keys),
                                                jnp.asarray(pay))]


def test_shuffle_matches_reference_one_shard():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << 32, 24, dtype=np.uint64).astype(np.uint32)
    pay = np.stack([np.arange(24), rng.integers(0, 2, 24)], -1).astype(
        np.int32)
    wk, wp, wd = _j_shuffle_1(keys, pay, 32)
    gk, gp, gd = mr.shuffle_records(_t(keys)[None], torch.from_numpy(pay)[
        None], n_shards=1, capacity=32)
    np.testing.assert_array_equal(gk[0].numpy(), wk.astype(np.int64))
    np.testing.assert_array_equal(gp[0].numpy(), wp)
    assert int(gd[0]) == int(wd[0]) == 0


def test_shuffle_keeps_the_slot_the_reference_loses():
    """Where some record is not sent (a padding key, or one past the
    capacity), the reference's scatter also writes the not-sent rows —
    to slot 0 with its old value — and on the CPU the last write wins, so
    the first record bound for shard 0 is lost silently. The port sends
    every record that fits and counts the rest in ``dropped``; all other
    slots equal the reference's."""
    keys = np.uint32([4, 8, EMPTY, 5, 6])
    pay = np.stack([np.int32([10, 11, -1, 12, 13]),
                    np.int32([1, 0, 0, 0, 0])], -1)
    for cap, dropped in ((8, 0), (3, 1)):
        wk, wp, wd = _j_shuffle_1(keys, pay, cap)
        gk, gp, gd = mr.shuffle_records(_t(keys)[None], torch.from_numpy(
            pay)[None], n_shards=1, capacity=cap)
        gk, gp = gk[0].numpy(), gp[0].numpy()
        assert (gk[0], tuple(gp[0])) == (4, (10, 1))     # the port keeps it
        assert (wk[0], tuple(wp[0])) == (EMPTY, (-1, -1))  # the reference
        np.testing.assert_array_equal(gk[1:], wk[1:].astype(np.int64))
        np.testing.assert_array_equal(gp[1:], wp[1:])
        assert int(gd[0]) == int(wd[0]) == dropped


@pytest.mark.parametrize("devices", [["cpu"] * 4,
                                     ["cpu:0", "cpu:1", "cpu:1", "cpu:0"]])
def test_shuffle_routes_by_owner_and_counts_overflow(devices):
    """recv[dst][src] = send[src][dst]: every sent record lands on shard
    key % n in its source's arrival order, on one stack or two."""
    rng = np.random.default_rng(2)
    n, m, cap = 4, 30, 6
    keys = rng.integers(0, 1 << 32, (n, m), dtype=np.uint64).astype(
        np.uint32)
    keys[1, :3] = EMPTY
    pay = np.stack([np.arange(n * m).reshape(n, m),
                    np.zeros((n, m), int)], -1).astype(np.int32)
    groups = group_devices([torch.device(d) for d in devices])
    sends_k, sends_p, drops = [], [], {}
    for dev, members in groups:
        sk, sp, dr = mr._pack_send(_t(keys)[members], torch.from_numpy(
            pay)[members], n_shards=n, capacity=cap)
        sends_k.append(sk)
        sends_p.append(sp)
        drops.update(zip(members, dr.tolist()))
    rk = {s: row for (_, mem), t in zip(groups, mr._exchange(
        sends_k, groups, n)) for s, row in zip(mem, t)}
    rp = {s: row for (_, mem), t in zip(groups, mr._exchange(
        sends_p, groups, n)) for s, row in zip(mem, t)}
    one_k, one_p, one_d = mr.shuffle_records(
        _t(keys), torch.from_numpy(pay), n_shards=n, capacity=cap)
    for dst in range(n):
        np.testing.assert_array_equal(rk[dst].numpy(), one_k[dst].numpy())
        np.testing.assert_array_equal(rp[dst].numpy(), one_p[dst].numpy())
        for src in range(n):
            sent = [(int(k), int(i)) for k, i in zip(keys[src], pay[src, :, 0])
                    if k != EMPTY and k % n == dst][:cap]
            blk_k = rk[dst][src * cap:(src + 1) * cap].tolist()
            blk_i = rp[dst][src * cap:(src + 1) * cap, 0].tolist()
            assert list(zip(blk_k, blk_i))[:len(sent)] == sent
            assert set(blk_k[len(sent):]) <= {EMPTY}
    for src in range(n):
        live = keys[src][keys[src] != EMPTY]
        want = sum(max(0, int((live % n == d).sum()) - cap)
                   for d in range(n))
        assert drops[src] == int(one_d[src]) == want


# ---------------------------------------------------- distributed flip join
def _j_dfj_1(qs, rs, qid, rid, cfg):
    """The reference's join on a one-device mesh, jitted whole (its eager
    shard_map dispatches every op on its own)."""
    mesh = jax.make_mesh((1,), ("data",))
    fn = jax.jit(lambda *a: j_dfj(*a, f=32, d=1, mesh=mesh, cfg=cfg))
    return [np.asarray(x) for x in fn(
        jnp.asarray(qs), jnp.asarray(rs), jnp.asarray(qid),
        jnp.asarray(rid))]


def _t_dfj(qs, rs, qid, rid, d=1, devices=None, **kw):
    n = kw.pop("n_shards", 1)
    return [x.numpy() for x in mr.distributed_flip_join(
        u32_to_i32(qs), u32_to_i32(rs), torch.from_numpy(qid),
        torch.from_numpy(rid), f=32, d=d,
        cfg=mr.MapReduceConfig(n_shards=n, **kw), devices=devices)]


@pytest.mark.parametrize("salting,thr", [(False, 64), (True, 64),
                                         (True, 1)])
def test_distributed_flip_join_matches_reference_one_shard(sigs, salting,
                                                           thr):
    qs, rs = sigs
    ids = np.arange(32, dtype=np.int32)
    kw = dict(shuffle_capacity=2048, max_pairs_per_shard=4096,
              salting=salting, hot_threshold=thr)
    want = _j_dfj_1(qs, rs, ids, ids, JConfig(n_shards=1, **kw))
    got = _t_dfj(qs, rs, ids, ids, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    truth = pairs_to_set(np.asarray(j_flip_join(
        jnp.asarray(qs), jnp.asarray(rs), f=32, d=1, max_pairs=4096)[0]))
    assert pairs_to_set(got[0]) == truth and got[2].sum() == 0


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("salting", [False, True])
def test_distributed_flip_join_shards_find_the_flip_join(sigs, n, salting):
    """n shards on one stack and on two stacks; with padding rows (id -1)
    too: the pair set is the flip join's, nothing dropped."""
    qs, rs = sigs
    ids = np.arange(32, dtype=np.int32)
    truth = pairs_to_set(np.asarray(j_flip_join(
        jnp.asarray(qs), jnp.asarray(rs), f=32, d=1, max_pairs=4096)[0]))
    kw = dict(n_shards=n, shuffle_capacity=2048, max_pairs_per_shard=4096,
              salting=salting, hot_threshold=2)
    one = _t_dfj(qs, rs, ids, ids, devices=["cpu"] * n, **kw)
    two = _t_dfj(qs, rs, ids, ids, devices=["cpu:0", "cpu:1"] * (n // 2),
                 **kw)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)
    assert pairs_to_set(one[0]) == truth and one[2].sum() == 0
    assert one[0].shape == (n * 4096, 2) and one[1].shape == (n,)
    pad_q, pad_r = ids.copy(), ids.copy()
    pad_q[[3, 17]] = -1
    pad_r[[0, 31]] = -1
    got = _t_dfj(qs, rs, pad_q, pad_r, devices=["cpu"] * n, **kw)
    assert pairs_to_set(got[0]) == {
        (q, r) for q, r in truth if q not in (3, 17) and r not in (0, 31)}
    assert got[2].sum() == 0


def test_distributed_flip_join_skew_is_salted(sigs):
    """One hot bucket (16 copies of one signature) split over the salts:
    the pair set is unchanged and no reducer holds it whole."""
    qs, rs = sigs
    rs_hot, qs_hot = np.tile(rs[:1], (16, 1)), np.tile(qs[:1], (4, 1))
    truth = pairs_to_set(np.asarray(j_flip_join(
        jnp.asarray(qs_hot), jnp.asarray(rs_hot), f=32, d=0,
        max_pairs=4096)[0]))
    got = _t_dfj(qs_hot, rs_hot, np.arange(4, dtype=np.int32),
                 np.arange(16, dtype=np.int32), d=0, devices=["cpu"] * 4,
                 n_shards=4, shuffle_capacity=2048, max_pairs_per_shard=4096,
                 salting=True, hot_threshold=2, n_salt=4)
    assert pairs_to_set(got[0]) == truth and got[2].sum() == 0


def test_distributed_flip_join_refuses_ragged_shards(sigs):
    qs, rs = sigs
    with pytest.raises(ValueError, match="multiple of 3"):
        _t_dfj(qs, rs, np.arange(32, dtype=np.int32),
               np.arange(32, dtype=np.int32), devices=["cpu"] * 3,
               n_shards=3)


# -------------------------------------------------------------- ring sweep
@pytest.mark.parametrize("d,cap", [(1, 4096), (12, 50)])
def test_ring_sweep_matches_reference_one_shard(sigs, d, cap):
    qs, rs = sigs
    mesh = jax.make_mesh((1,), ("data",))
    wp, wc = jax.jit(lambda q, r: j_ring(q, r, d=d, mesh=mesh,
                                         max_pairs_per_shard=cap))(
        jnp.asarray(qs), jnp.asarray(rs))
    ops.reset_launches()
    gp, gc = mr.ring_sweep(u32_to_i32(qs), u32_to_i32(rs), d=d,
                           devices=["cpu"], max_pairs_per_shard=cap)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert ops.LAUNCHES["hamming_dist"] == 0     # the twin ran on the CPU


def test_ring_sweep_shards_find_the_flip_join(sigs):
    qs, rs = sigs
    truth = pairs_to_set(np.asarray(j_flip_join(
        jnp.asarray(qs), jnp.asarray(rs), f=32, d=1, max_pairs=4096)[0]))
    for devices in (["cpu"] * 2, ["cpu"] * 4, ["cpu:0", "cpu:1"] * 2):
        gp, gc = mr.ring_sweep(u32_to_i32(qs), u32_to_i32(rs), d=1,
                               devices=devices, max_pairs_per_shard=4096)
        assert pairs_to_set(gp.numpy()) == truth
        assert int(gc.sum()) == len(truth)


# ------------------------------------------- the reference's 2 and 4 devices
_SUBPROCESS = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.mapreduce import (MapReduceConfig, distributed_flip_join,
                                  ring_sweep, shuffle_records)
from repro.util import shard_map_compat
assert jax.device_count() == 4, jax.devices()
z = np.load(sys.argv[2])
qs, rs, qid, rid = z["qs"], z["rs"], z["qid"], z["rid"]
keys, pay = z["keys"], z["pay"]
out = {}
for n in (2, 4):
    mesh = jax.make_mesh((n,), ("data",))
    for salting, cap, mp in ((False, 2048, 4096), (True, 2048, 16)):
        cfg = MapReduceConfig(n_shards=n, shuffle_capacity=cap,
                              max_pairs_per_shard=mp, salting=salting,
                              hot_threshold=2)
        p, c, dr = jax.jit(lambda *a: distributed_flip_join(
            *a, f=32, d=1, mesh=mesh, cfg=cfg))(
            jnp.asarray(qs), jnp.asarray(rs), jnp.asarray(qid),
            jnp.asarray(rid))
        key = f"dfj_{n}_{int(salting)}_{cap}_{mp}"
        out[key + "_pairs"], out[key + "_counts"] = np.asarray(p), np.asarray(c)
        out[key + "_dropped"] = np.asarray(dr)
    for d, mp in ((1, 4096), (12, 50)):
        p, c = jax.jit(lambda q, r: ring_sweep(
            q, r, d=d, mesh=mesh, max_pairs_per_shard=mp))(
            jnp.asarray(qs), jnp.asarray(rs))
        out[f"ring_{n}_{d}_pairs"], out[f"ring_{n}_{d}_counts"] = (
            np.asarray(p), np.asarray(c))
    fn = shard_map_compat(
        lambda k, p: (lambda a, b, c: (a, b, c[None]))(*shuffle_records(
            k, p, axis_name="data", n_shards=n, capacity=16)),
        mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data")))
    k2, p2, d2 = jax.jit(fn)(jnp.asarray(keys[:n].reshape(-1)),
                    jnp.asarray(pay[:n].reshape(-1, 2)))
    out[f"shuffle_{n}_keys"], out[f"shuffle_{n}_pay"] = (np.asarray(k2),
                                                         np.asarray(p2))
    out[f"shuffle_{n}_dropped"] = np.asarray(d2)
np.savez(sys.argv[1], **out)
print("MAPREDUCE4-DONE")
"""


@pytest.mark.slow
def test_port_matches_reference_real_multi_device_programs(sigs, tmp_path):
    """The reference's shard_map programs on 2 and 4 XLA-forced host
    devices (a subprocess) == the port's n shards: the shuffle's received
    buffers, the distributed flip join (pairs slot for slot, counts,
    dropped; with salting and with truncating pair buffers) and the ring
    sweep (a truncating buffer too)."""
    qs, rs = sigs
    ids = np.arange(32, dtype=np.int32)
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 1 << 32, (4, 20), dtype=np.uint64).astype(
        np.uint32)
    pay = np.stack([np.arange(80).reshape(4, 20),
                    rng.integers(0, 2, (4, 20))], -1).astype(np.int32)
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, qs=qs, rs=rs, qid=ids, rid=ids, keys=keys, pay=pay)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS, str(out),
                           str(inp)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and "MAPREDUCE4-DONE" in proc.stdout, \
        proc.stderr[-3000:]
    want = np.load(out)
    for n in (2, 4):
        for devices in (["cpu"] * n, ["cpu:0", "cpu:1"] * (n // 2)):
            for salting, cap, mp in ((False, 2048, 4096), (True, 2048, 16)):
                key = f"dfj_{n}_{int(salting)}_{cap}_{mp}"
                got = _t_dfj(qs, rs, ids, ids, devices=devices, n_shards=n,
                             shuffle_capacity=cap, max_pairs_per_shard=mp,
                             salting=salting, hot_threshold=2)
                for name, g in zip(("pairs", "counts", "dropped"), got):
                    np.testing.assert_array_equal(
                        g, want[f"{key}_{name}"], err_msg=(key, devices))
            for d, mp in ((1, 4096), (12, 50)):
                gp, gc = mr.ring_sweep(u32_to_i32(qs), u32_to_i32(rs), d=d,
                                       devices=devices,
                                       max_pairs_per_shard=mp)
                np.testing.assert_array_equal(gp.numpy(),
                                              want[f"ring_{n}_{d}_pairs"])
                np.testing.assert_array_equal(gc.numpy(),
                                              want[f"ring_{n}_{d}_counts"])
        gk, gp, gd = mr.shuffle_records(_t(keys[:n]), torch.from_numpy(
            pay[:n]), n_shards=n, capacity=16)
        np.testing.assert_array_equal(gk.numpy().reshape(-1),
                                      want[f"shuffle_{n}_keys"])
        np.testing.assert_array_equal(gp.numpy().reshape(-1, 2),
                                      want[f"shuffle_{n}_pay"])
        np.testing.assert_array_equal(gd.numpy(),
                                      want[f"shuffle_{n}_dropped"])
