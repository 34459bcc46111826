"""The port's checkpoint manager (``repro_torch.checkpoint``) beside the
reference's (``repro.checkpoint``): the same on-disk format — a
checkpoint the JAX package wrote, bf16 leaves included, loads in the
port and training continues from it — plus the reference's own tests on
the port: bitwise round trip, keep-last GC, atomic save over a stale
``.tmp``, and restart continuation bitwise on the CPU.

Restart against the reference: the reference trains yi-9b smoke in fp32
for 3 steps and saves; the port restores that manifest through
``train_state_from_reference``, trains 3 more steps, and is held to the
reference's 6 straight steps: losses within 1e-5, masters within 1e-5 on
all but 0.01% of the elements and none beyond 2·lr (as in
``test_torch_train.py``).
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data.lm_data import LMDataConfig as JLMDataConfig
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.lm_data import LMDataConfig, lm_batches
from repro_torch.train import (AdamWConfig, TrainConfig, init_train_state,
                               make_train_step, train_state_from_reference)
from test_torch_train import (_case, _port_run, _ref_run,
                              assert_masters_close)

CPU = torch.device("cpu")


def _smoke_setup(n_micro=1):
    cfg = configs.get_smoke_config("yi-9b")
    tc = TrainConfig(n_microbatches=n_micro,
                     opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50))
    step = make_train_step(cfg, tc)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, CPU)
    dc = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    return cfg, step, state, dc


def _leaves(tree):
    from repro_torch.util import tree_flatten
    return [t for _, t in tree_flatten(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_checkpoint_roundtrip_bitwise(tmp_path):
    _, _, state, _ = _smoke_setup()
    mgr = CheckpointManager(tmp_path, keep_last=2)
    mgr.save(3, state.tree())
    restored, s = mgr.restore(state.tree())
    assert s == 3
    _assert_trees_equal(state.tree(), restored)
    dtypes = {t.dtype for t in _leaves(restored)}
    assert {torch.bfloat16, torch.float32, torch.int32} <= dtypes


def test_bf16_int32_and_float8_leaves_on_disk(tmp_path):
    """The reference's format: bf16 stored as its uint16 bits, float8 as
    uint8, the logical dtype in the manifest; the reference reads what
    the port wrote."""
    tree = {"a": torch.randn(3, 5).to(torch.bfloat16),
            "b": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "c": [torch.randn(4), torch.randn(7).to(torch.float8_e4m3fn)],
            "d": torch.tensor(7, dtype=torch.int32)}
    CheckpointManager(tmp_path).save(1, tree)
    man = json.loads((tmp_path / "step_00000001" / "manifest.json")
                     .read_text())
    by_path = {e["path"]: e for e in man["leaves"]}
    assert man["step"] == 1
    assert [e["path"] for e in man["leaves"]] == ["a", "b", "c/0", "c/1",
                                                  "d"]
    assert by_path["a"]["dtype"] == "bfloat16"
    assert by_path["c/1"]["dtype"] == "float8_e4m3fn"
    assert by_path["b"] == {"path": "b", "file": "leaf_00001.npy",
                            "shape": [2, 3], "dtype": "int32"}
    raw = np.load(tmp_path / "step_00000001" / by_path["a"]["file"])
    assert raw.dtype == np.uint16
    restored, _ = CheckpointManager(tmp_path).restore(tree)
    _assert_trees_equal(tree, restored)
    like = {"a": jnp.zeros((3, 5), jnp.bfloat16),
            "b": jnp.zeros((2, 3), jnp.int32),
            "c": [jnp.zeros(4), jnp.zeros(7, jnp.float8_e4m3fn)],
            "d": jnp.zeros((), jnp.int32)}
    jtree, _ = JCheckpointManager(tmp_path).restore(like)
    np.testing.assert_array_equal(
        np.asarray(jtree["a"]).view(np.uint16),
        tree["a"].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(np.asarray(jtree["b"]), tree["b"].numpy())


def test_checkpoint_gc_keeps_last_n(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones(3) * s})
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_atomic_save_survives_partial_tmp(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.arange(4, dtype=torch.int32)})
    # a crash mid-write of step 2: a stale tmp dir, no manifest
    (tmp_path / "step_00000002.tmp").mkdir()
    assert mgr.latest_step() == 1
    restored, s = mgr.restore({"x": torch.zeros(4, dtype=torch.int32)})
    assert s == 1 and restored["x"].tolist() == [0, 1, 2, 3]
    # the next save of step 2 writes over the stale directory
    mgr.save(2, {"x": torch.ones(4, dtype=torch.int32)})
    assert mgr.all_steps() == [1, 2]
    assert not (tmp_path / "step_00000002.tmp").exists()


def test_restore_checks_shapes_and_missing_checkpoints(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.zeros(4)})
    mgr.save(1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch at x"):
        mgr.restore({"x": torch.zeros(5)})


def test_checkpoint_restart_continuation_is_bitwise(tmp_path):
    """Kill/restart invariant: train 6 steps straight == train 3,
    checkpoint, 'crash', restore, train 3 more (stateless data)."""
    cfg, step, state0, dc = _smoke_setup()

    def run(n_start, n_end, state):
        for s in range(n_start, n_end):
            x, y = lm_batches(dc, s, device=CPU)
            state, _ = step(state, {"inputs": x, "targets": y})
        return state

    straight = run(0, 6, copy.deepcopy(state0))
    mgr = CheckpointManager(tmp_path)
    mid = run(0, 3, copy.deepcopy(state0))
    mgr.save(3, mid.tree())
    del mid                                   # "crash"
    resumed = copy.deepcopy(state0)           # structure only
    tree, s = mgr.restore(resumed.tree())
    resumed.load_tree(tree)
    assert s == 3 and int(resumed.step) == 3
    resumed = run(3, 6, resumed)
    _assert_trees_equal(straight.tree(), resumed.tree())


def test_async_writes_copy_at_save_and_land_by_wait(tmp_path):
    _, step, state, dc = _smoke_setup()
    mgr = CheckpointManager(tmp_path, keep_last=5, async_writes=True)
    snaps = {}
    for s in range(3):
        x, y = lm_batches(dc, s, device=CPU)
        state, _ = step(state, {"inputs": x, "targets": y})
        snaps[s + 1] = copy.deepcopy(state.tree())
        mgr.save(s + 1, state.tree(), block=False)  # the next step mutates
    mgr.wait()
    assert mgr.all_steps() == [1, 2, 3]
    for s, snap in snaps.items():
        restored, _ = mgr.restore(snap, step=s)
        _assert_trees_equal(snap, restored)


def test_async_write_failure_is_raised_by_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, async_writes=True)

    def broken(step, host):
        raise OSError("disk full")
    monkeypatch.setattr(mgr, "_write", broken)
    mgr.save(1, {"x": torch.zeros(2)}, block=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                                # reported once


def test_jax_checkpoint_loads_and_training_continues(tmp_path):
    jcfg, p, tcfg = _case("yi-9b")
    dc = JLMDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                       global_batch=4)
    straight, want, batches = _ref_run(jcfg, p, dc, 6, 1)
    mid, _, _ = _ref_run(jcfg, p, dc, 3, 1)
    JCheckpointManager(tmp_path).save(3, mid)
    tree, s = CheckpointManager(tmp_path).restore()
    assert s == 3 and set(tree) == {"0", "1", "2"}
    state = train_state_from_reference(tree, tcfg, CPU)
    assert int(state.step) == int(state.opt_state["step"]) == 3
    state, got = _port_run(state, tcfg, batches[3:], 1)
    np.testing.assert_allclose(got, want[3:], rtol=0, atol=1e-5)
    assert_masters_close(state, straight.opt_state["master"], tcfg, 1e-3)


def test_jax_bf16_checkpoint_leaves_come_back_bit_for_bit(tmp_path):
    jcfg, p, tcfg = _case("recurrentgemma-2b", "bfloat16")
    JCheckpointManager(tmp_path).save(5, {"params": p})
    tree, _ = CheckpointManager(tmp_path).restore()
    from repro_torch.models import params_from_reference
    from repro_torch.models.model import reference_leaf
    model = params_from_reference(tree["params"], tcfg, CPU)
    for name, prm in model.named_parameters():
        want = np.asarray(reference_leaf(p, tcfg, name))
        got = prm.detach()
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
