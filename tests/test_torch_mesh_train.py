"""The port's training step over a mesh (``make_train_step(..., mesh)``,
``init_train_state(mesh=)``, ``batch_sharding``) and the elastic restore
(``CheckpointManager.restore(sharding_tree=)``), on ``["cpu"] * 4``.

One sharded step of the port is held against the port's unsharded step
and against the reference's unsharded jitted step, on the same weights
(the reference's tree, drawn with numpy) and the same batch. The
reference's own sharded step fails on a mesh from ``jax.make_mesh``,
whose axes are ``Explicit`` in this jax (its embedding gather raises
``DuplicateSpecError`` at one microbatch, its microbatch scan "0th
dimension of all xs should be replicated" at two); on a mesh with
``Auto`` axes it runs, and ``test_torch_tensor_parallel.py`` holds this
file's (2, 2) steps to it by the same bars.

Bars, float32, the card check's: loss within 1e-4; each gradient leaf
within 1e-3 of its max abs (the first step's mu is (1 - b1)·clip·g, so
it is held as the gradient); the masters within 1e-5 on all but 0.01% of
the elements and none beyond 2·lr. The block order costs: the global
norm sums each leaf over its distinct blocks (not the reference's
reduction order) and the rows' CE sums add on the first row's entry,
each a few fp32 ulps (measured on these inputs: losses within 1e-6,
masters within 6e-7).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import TrainState as JTrainState
from repro.train import adamw_init as j_adamw_init
from repro.train import make_train_step as j_make_train_step
from repro.train.train_lib import batch_sharding as j_batch_sharding
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import sharding as shd
from repro_torch.models.model import ShardedLM
from repro_torch.train import (AdamWConfig, TrainConfig, make_train_step,
                               train_state_from_reference)
from repro_torch.train.train_lib import (batch_sharding, place_batch,
                                         shard_train_state, state_sharding)
from test_torch_train import _case, _ref

CPU = torch.device("cpu")
B, S = 4, 16
LR = 1e-3


def _opt():
    return dict(lr=LR, warmup_steps=1, total_steps=10)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _fresh(arch):
    jcfg, p, tcfg = _case(arch)
    js = JTrainState(params=p, opt_state=j_adamw_init(p),
                     step=np.zeros((), np.int32))
    return train_state_from_reference(jax.tree.map(np.asarray, js), tcfg,
                                      CPU)


@functools.lru_cache(maxsize=None)
def _reference_step(arch, nm):
    """The reference's TrainState after one jitted unsharded step, and
    its loss."""
    jcfg, p, _ = _case(arch)
    step = jax.jit(j_make_train_step(jcfg, JTrainConfig(
        n_microbatches=nm, opt=JAdamWConfig(**_opt())), None))
    js = JTrainState(params=p, opt_state=j_adamw_init(p),
                     step=jnp.zeros((), jnp.int32))
    js, m = step(js, _batch(jcfg))
    return jax.tree.map(np.asarray, js), float(m["loss"])


@functools.lru_cache(maxsize=None)
def _port_step(arch, nm):
    _, _, tcfg = _case(arch)
    state = _fresh(arch)
    step = make_train_step(tcfg, TrainConfig(n_microbatches=nm,
                                             opt=AdamWConfig(**_opt())))
    state, m = step(state, _tb(_batch(tcfg)))
    return state, float(m["loss"])


def _mesh(shape):
    return shd.Mesh(shape, ("data", "model"), ["cpu"] * 4)


def _sharded_step(arch, shape, nm, fsdp=True):
    _, _, tcfg = _case(arch)
    mesh = _mesh(shape)
    rules = shd.make_rules(tcfg, mesh, fsdp=fsdp)
    state = shard_train_state(_fresh(arch), mesh, rules)
    step = make_train_step(tcfg, TrainConfig(n_microbatches=nm,
                                             opt=AdamWConfig(**_opt())),
                           mesh, rules)
    state, m = step(state, place_batch(_tb(_batch(tcfg)), mesh, tcfg))
    return state, m


def _check(got, want, name):
    """``got`` (dict name -> array) against ``want`` by the bars."""
    far = total = 0
    for n, w in want["master"].items():
        d = np.abs(got["master"][n] - w)
        assert d.max() <= 2 * LR * (1 + 1e-3), (name, n)
        far += int((d > 1e-5).sum())
        total += d.size
        g, gw = got["mu"][n], want["mu"][n]
        scale = np.abs(gw).max()
        assert np.abs(g - gw).max() <= 1e-3 * scale + 1e-12, (name, n)
    assert far <= 1e-4 * total, (name, far, total)


def _full(state):
    return {k: {n: t.full("cpu").numpy() for n, t in
                state.opt_state[k].items()} for k in ("master", "mu")}


def check_sharded_step(arch, shape, nm):
    """One sharded step against the port's and the reference's unsharded
    steps, by the bars."""
    jcfg, _, tcfg = _case(arch)
    sharded, m = _sharded_step(arch, shape, nm)
    port, port_loss = _port_step(arch, nm)
    js, j_loss = _reference_step(arch, nm)
    assert abs(float(m["loss"]) - port_loss) <= 1e-4
    assert abs(float(m["loss"]) - j_loss) <= 1e-4
    assert int(sharded.step) == 1
    got = _full(sharded)
    _check(got, {k: {n: t.numpy() for n, t in port.opt_state[k].items()}
                 for k in ("master", "mu")}, "port")
    _check(got, {k: {n: _ref(js.opt_state[k], tcfg, n)
                     for n in port.opt_state[k]} for k in ("master", "mu")},
           "reference")
    # the compute params are the masters' blocks cast
    for n, p in sharded.params.items():
        assert torch.equal(p.full("cpu"), sharded.opt_state["master"][n]
                           .full("cpu").to(p.dtype))


@pytest.mark.parametrize("nm", [1, 2])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_sharded_step_matches_both_unsharded_steps(arch, shape, nm):
    """The dense and MoE families (olmoe's aux loss rebuilt from the
    rows' routing statistics); the recurrent families are in
    ``test_torch_mesh_train_recurrent.py``."""
    check_sharded_step(arch, shape, nm)


def test_zero1_gives_the_same_step():
    """make_rules(fsdp=False): compute parameters whole over "data", the
    masters split; the step's numbers are the FSDP step's."""
    a, _ = _sharded_step("yi-9b", (2, 2), 2)
    b, _ = _sharded_step("yi-9b", (2, 2), 2, fsdp=False)
    assert b.model.params["layers.0.attn.wq"].spec == (None, "model")
    assert a.model.params["layers.0.attn.wq"].spec == ("data", "model")
    assert b.opt_state["master"]["layers.0.attn.wq"].spec == ("data", "model")
    for k in ("master", "mu", "nu"):
        for n, t in a.opt_state[k].items():
            assert torch.equal(t.full("cpu"), b.opt_state[k][n].full("cpu"))
    for n, t in a.params.items():
        assert torch.equal(t.full("cpu"), b.params[n].full("cpu"))


def _leaves_equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _leaves_equal(a[k], b[k])
        return
    x = a.full("cpu") if isinstance(a, shd.Sharded) else a
    y = b.full("cpu") if isinstance(b, shd.Sharded) else b
    assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("new", [(4, 1), (1, 1)])
def test_elastic_restore_is_bitwise(tmp_path, new):
    """A (2, 2) state saved after a step comes back on (4, 1) or (1, 1)
    leaf for leaf, and trains on there as it would have on (2, 2)."""
    state, _ = _sharded_step("olmoe-1b-7b", (2, 2), 2)
    _, _, tcfg = _case("olmoe-1b-7b")
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state.tree())
    n_dev = 4 if new == (4, 1) else 1
    mesh = shd.Mesh(new, ("data", "model"), ["cpu"] * n_dev)
    tree, step = mgr.restore(state.tree(), sharding_tree=state_sharding(
        state, mesh))
    assert step == 1
    _leaves_equal(state.tree(), tree)
    same, _ = mgr.restore(state.tree())       # placed as ``like`` is
    _leaves_equal(state.tree(), same)
    assert same["params"]["embedding"].mesh is state.model.mesh
    assert next(iter(tree["params"].values())).mesh is mesh
    moved = copy.deepcopy(state)
    moved.load_tree(tree)
    assert moved.model.mesh is mesh
    tc = TrainConfig(n_microbatches=2, opt=AdamWConfig(**_opt()))
    batch = _tb(_batch(tcfg, seed=1))
    a, ma = make_train_step(tcfg, tc, state.model.mesh)(state, batch)
    b, mb = make_train_step(tcfg, tc, mesh)(moved, batch)
    assert abs(float(ma["loss"]) - float(mb["loss"])) <= 1e-5
    for n, t in a.opt_state["master"].items():
        np.testing.assert_allclose(b.opt_state["master"][n].full("cpu"),
                                   t.full("cpu"), rtol=0, atol=1e-5)


def test_reference_checkpoint_restores_sharded_bitwise(tmp_path):
    """A TrainState the JAX package checkpointed (after one step, so every
    leaf differs) restored onto a (2, 2) mesh: params, masters and
    moments equal the reference's arrays bit for bit."""
    jcfg, _, tcfg = _case("recurrentgemma-2b")
    js, _ = _reference_step("recurrentgemma-2b", 1)
    JCheckpointManager(tmp_path).save(1, js)
    tree, step = CheckpointManager(tmp_path).restore()
    assert step == 1
    mesh = _mesh((2, 2))
    state = shard_train_state(train_state_from_reference(tree, tcfg, CPU),
                              mesh)
    assert isinstance(state.model, ShardedLM) and state.model.mesh is mesh
    for n, p in state.params.items():
        np.testing.assert_array_equal(p.full("cpu").numpy(),
                                      _ref(js.params, tcfg, n))
    for k in ("master", "mu", "nu"):
        for n, t in state.opt_state[k].items():
            assert isinstance(t, shd.Sharded)
            np.testing.assert_array_equal(t.full("cpu").numpy(),
                                          _ref(js.opt_state[k], tcfg, n))
    assert int(state.step) == int(js.step) == 1


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_batch_sharding_specs_match_reference(arch):
    """The batch axis over the DP axes, (B, S) tokens or (B, S, d)
    embeddings, single-pod and multi-pod."""
    cfg = configs.get_config(arch)
    from repro import configs as jconfigs
    jcfg = jconfigs.get_config(arch)
    for axes in (("data", "model"), ("pod", "data", "model")):
        jm = jax.make_mesh((1,) * len(axes), axes)
        want = j_batch_sharding(jm, jcfg)
        mesh = shd.Mesh((2,) * len(axes), axes, ["cpu"] * 2 ** len(axes))
        got = batch_sharding(mesh, cfg)
        for k in ("inputs", "targets"):
            assert got[k][0] is mesh
            assert got[k][1] == tuple(want[k].spec), (arch, axes, k)
    assert P(*got["targets"][1]) == want["targets"].spec
