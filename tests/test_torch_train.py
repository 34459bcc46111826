"""The port's LM training (``repro_torch.models.{chunked_ce, loss_fn,
train_step_fn}``, ``repro_torch.train``) held against the JAX package on
the CPU: the same parameters (the reference's tree, drawn with numpy and
carried over by ``params_from_reference`` / ``train_state_from_reference``)
and the same numpy batches through both.

Bars, float32: loss within 1e-5, every gradient leaf within 1e-4 of its
max abs (measured: 1.1e-6 to 7.7e-6 across the ten archs); optimizer
state within 1e-6 after updates on the same grads. Over whole training
steps the masters are held as the card's check holds them: within 1e-5
on all but 0.01% of the elements and none beyond 2·lr (Adam's first step
is near lr·sign(g), so a gradient that rounds across zero moves one
element by up to 2·lr). bfloat16 is an accuracy class, not a bar (XLA's
bf16 logistic and GELU round otherwise, and the port accumulates the
embedding's gradient in fp32): the dense, MoE and xLSTM families held
to the reference's own error against fp32, and the reference test's own
checks (finite, > 0, ce within 2 of ln V) on the port for all ten
archs.

The learning rate: torch's and XLA's float32 cosine differ by one ulp at
some arguments, so ``warmup_cosine`` is held to that ulp carried through
the schedule (exact in the warmup); on these schedules at most 3 of 101
steps differ.

The reference's ``loss_fn`` and ``make_train_step`` are jitted whole.
"""
import copy
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.lm_data import LMDataConfig as JLMDataConfig
from repro.data.lm_data import lm_batches as j_lm_batches
from repro.models import loss_fn as j_loss_fn
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import TrainState as JTrainState
from repro.train import adamw_init as j_adamw_init
from repro.train import adamw_update as j_adamw_update
from repro.train import make_train_step as j_make_train_step
from repro.train import warmup_cosine as j_warmup_cosine
from repro_torch import configs
from repro_torch.data.lm_data import LMDataConfig, lm_batches
from repro_torch.models import (init_params, params_from_reference,
                                reference_params, train_step_fn)
from repro_torch.models.model import reference_key, reference_leaf
from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                               adamw_update, init_train_state,
                               make_train_step, train_state_from_reference,
                               warmup_cosine)
from repro_torch.train.optimizer import reference_decay_mask
from test_torch_models import _np_params

CPU = torch.device("cpu")
B, S = 2, 32


def _cfgs(arch, dtype="float32"):
    return (jconfigs.get_smoke_config(arch).scaled(dtype=dtype),
            configs.get_smoke_config(arch).scaled(dtype=dtype))


@functools.lru_cache(maxsize=None)
def _case(arch, dtype="float32"):
    jcfg, tcfg = _cfgs(arch, dtype)
    return jcfg, _np_params(jcfg, seed=3), tcfg


def _batch(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        x = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    return {"inputs": x,
            "targets": rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)}


def _tb(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _j_grad(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: j_loss_fn(p, b, jcfg),
                                      has_aux=True))


def _ref(tree, cfg, name):
    return np.asarray(reference_leaf(tree, cfg, name))


# ------------------------------------------------------------ loss, grads
def _check_loss_and_grads(arch, n):
    jcfg, p, tcfg = _case(arch)
    batch = _batch(jcfg, n)
    (loss, m), grads = _j_grad(jcfg)(p, batch)
    model = params_from_reference(p, tcfg, CPU)
    lt, mt, gt = train_step_fn(model, _tb(batch))
    assert abs(float(lt) - float(loss)) <= 1e-5
    assert abs(float(mt["ce"]) - float(m["ce"])) <= 1e-5
    assert abs(float(mt["aux"]) - float(m["aux"])) <= 1e-5
    assert int(mt["tokens"]) == int(m["tokens"]) == B * n
    assert list(gt) == list(reference_params(model))
    for name, g in gt.items():
        want = _ref(grads, tcfg, name)
        assert g.dtype == model.get_parameter(name).dtype
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_loss_and_grads_match_reference_float32(arch):
    _check_loss_and_grads(arch, S)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "yi-9b"])
def test_loss_and_grads_off_the_chunks(arch):
    """S = 24 leaves a partial attention / mLSTM chunk and a partial CE
    chunk: the mLSTM padding finding touches only the carried state, so
    the full forward's loss and grads still equal the reference's."""
    cfg = configs.get_smoke_config(arch)
    assert 24 % cfg.attn_chunk and 24 % cfg.ce_chunk
    _check_loss_and_grads(arch, 24)


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b", "xlstm-1.3b"])
def test_loss_and_grads_bfloat16_accuracy_class(arch):
    """bf16 on the same weights: loss within 0.01 of the reference's
    (measured: at most 0.0024, xlstm), and each package's grads against
    the fp32 grads of the upcast weights: the port's worst leaf error (x
    the leaf's max abs) at most 1.5x the reference's + 0.02 (measured
    ratio at most 1.19, yi-9b; olmoe's 0.373 is a router flipped by bf16
    rounding in both)."""
    jcfg, p, tcfg = _case(arch, "bfloat16")
    jcfg32 = _case(arch)[0]
    batch = _batch(jcfg, S)
    (loss, _), grads = _j_grad(jcfg)(p, batch)
    _, truth = _j_grad(jcfg32)(jax.tree.map(
        lambda a: np.asarray(a, np.float32), p), batch)
    model = params_from_reference(p, tcfg, CPU)
    lt, _, gt = train_step_fn(model, _tb(batch))
    assert abs(float(lt) - float(loss)) <= 0.01
    err_port = err_ref = 0.0
    for name, g in gt.items():
        assert g.dtype == model.get_parameter(name).dtype, name
        assert bool(torch.isfinite(g).all()), name
        want = _ref(truth, tcfg, name)
        scale = max(float(np.abs(want).max()), 1e-30)
        err_port = max(err_port,
                       float(np.abs(g.float().numpy() - want).max()) / scale)
        err_ref = max(err_ref, float(np.abs(
            _ref(grads, tcfg, name).astype(np.float32) - want).max()) / scale)
    assert err_port <= 1.5 * err_ref + 0.02, (err_port, err_ref)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_smoke_train_step_bfloat16(arch):
    """The reference's ``test_smoke_train_step`` on the port."""
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, torch.Generator().manual_seed(1), CPU)
    loss, metrics, grads = train_step_fn(model, _tb(_batch(cfg, 16)))
    assert math.isfinite(float(loss)) and float(loss) > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert any(float(g.abs().max()) > 0 for g in grads.values())
    assert abs(float(metrics["ce"]) - np.log(cfg.vocab_size)) < 2.0
    for name, g in grads.items():
        assert g.dtype == model.get_parameter(name).dtype, name


def test_remat_recomputes_each_layer_and_changes_no_number(monkeypatch):
    """With ``cfg.remat`` each layer's forward runs again in the backward
    pass (one checkpoint a layer); the numbers are the same without it."""
    from repro_torch.models.model import Block
    jcfg, p, tcfg = _case("olmoe-1b-7b")
    batch = _tb(_batch(jcfg, 24))
    calls, forward = [], Block.forward

    def counted(self, *a, **k):
        calls.append(self)
        return forward(self, *a, **k)
    monkeypatch.setattr(Block, "forward", counted)
    out = {}
    for remat in (True, False):
        model = params_from_reference(p, tcfg.scaled(remat=remat), CPU)
        calls.clear()
        out[remat] = (train_step_fn(model, batch), len(calls))
    (l1, _, g1), n1 = out[True]
    (l0, _, g0), n0 = out[False]
    assert (n1, n0) == (2 * tcfg.n_layers, tcfg.n_layers)
    assert torch.equal(l1, l0)
    for name in g0:
        assert torch.equal(g1[name], g0[name]), name


def test_chunked_ce_ignores_negative_targets():
    jcfg, p, tcfg = _case("yi-9b")
    batch = _batch(jcfg, 20)
    batch["targets"][:, 15:] = -1
    (loss, m), _ = _j_grad(jcfg)(p, batch)
    lt, mt, _ = train_step_fn(params_from_reference(p, tcfg, CPU),
                              _tb(batch))
    assert int(mt["tokens"]) == int(m["tokens"]) == B * 15
    assert abs(float(lt) - float(loss)) <= 1e-5


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("kw", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    dict(lr=1e-3, warmup_steps=2, total_steps=50), {}])
def test_warmup_cosine_matches_reference(kw):
    jc, tc = JAdamWConfig(**kw), AdamWConfig(**kw)
    want = np.array([j_warmup_cosine(jc, s) for s in range(101)], np.float32)
    got = np.array([warmup_cosine(tc, s) for s in range(101)], np.float32)
    # one ulp of the cosine, times (1 - min_lr_ratio)·lr/2, plus the
    # rounding of the rate itself
    np.testing.assert_allclose(got, want, rtol=2**-23, atol=tc.lr * 2**-24)
    warm = np.arange(101) < tc.warmup_steps
    np.testing.assert_array_equal(got[warm], want[warm])
    assert (got != want).sum() <= 3


def test_warmup_cosine_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(warmup_cosine(cfg, s)) for s in range(101)]
    assert lrs[0] == 0.0 and abs(lrs[10] - 1.0) < 1e-6
    assert abs(lrs[100] - 0.1) < 1e-6
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))


def test_adamw_update_matches_reference():
    """Two updates on the same grads (bf16 params under fp32 masters):
    masters, mu and nu within 1e-6, compute params in their dtypes."""
    jcfg, p, tcfg = _case("yi-9b", "bfloat16")
    model = params_from_reference(p, tcfg, CPU)
    params = reference_params(model)
    jstate, state = j_adamw_init(p), adamw_init(params)
    jc = JAdamWConfig(warmup_steps=1, total_steps=10)
    tc = AdamWConfig(warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(4)
    jparams = p
    for _ in range(2):
        g = jax.tree.map(lambda a: np.asarray(jnp.asarray(
            rng.standard_normal(a.shape), a.dtype)), p)
        jparams, jstate, jst = jax.jit(
            lambda g, s, q: j_adamw_update(g, s, q, jc))(g, jstate, jparams)
        grads = {n: torch.from_numpy(np.array(_ref(g, tcfg, n),
                                                np.float32)).to(prm.dtype)
                 for n, prm in params.items()}
        _, state, st = adamw_update(grads, state, params, tc,
                                    decay=reference_decay_mask(model))
        assert abs(float(st["grad_norm"]) - float(jst["grad_norm"])) \
            <= 1e-5 * float(jst["grad_norm"])
        assert float(st["lr"]) == pytest.approx(float(jst["lr"]),
                                                rel=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 2
    for name, prm in params.items():
        for key in ("master", "mu", "nu"):
            np.testing.assert_allclose(
                state[key][name].numpy(), _ref(jstate[key], tcfg, name),
                rtol=0, atol=1e-6, err_msg=f"{key} {name}")
        want = _ref(jparams, tcfg, name)
        assert str(prm.dtype).removeprefix("torch.") == want.dtype.name
        np.testing.assert_allclose(prm.detach().float().numpy(),
                                   want.astype(np.float32), rtol=1e-2,
                                   atol=1e-6)


def test_decay_mask_follows_the_reference_leaf_shape():
    """Finding: the reference decays a leaf iff its ndim >= 2 in its own
    tree, where every stacked layer's 1-D leaf is (G, d). One update with
    zero grads moves exactly the decayed leaves by lr·wd·w: the RG-LRU
    ``lam`` of the repeated layer 0 moves, the same leaf of remainder
    layer 3 (``rem/r0``) and ``final_norm`` do not. The port's mask does
    the same; a plain ndim >= 2 test on the port's per-layer leaves would
    not."""
    jcfg, p, tcfg = _case("recurrentgemma-2b")
    assert tcfg.n_groups * len(tcfg.block_pattern) == 3
    jc = JAdamWConfig(warmup_steps=0, total_steps=10)
    tc = AdamWConfig(warmup_steps=0, total_steps=10)
    zeros = jax.tree.map(np.zeros_like, p)
    new, _, _ = jax.jit(lambda g, s, q: j_adamw_update(g, s, q, jc))(
        zeros, j_adamw_init(p), p)
    moved = {n for n in reference_params(params_from_reference(p, tcfg, CPU))
             if not np.array_equal(_ref(new, tcfg, n), _ref(p, tcfg, n))}
    assert "layers.0.rglru.lam" in moved and "layers.0.rglru.norm" in moved
    assert "layers.3.rglru.lam" not in moved and "final_norm" not in moved

    def port_moved(decay):
        model = params_from_reference(p, tcfg, CPU)
        params = reference_params(model)
        before = {n: t.detach().clone() for n, t in params.items()}
        adamw_update({n: torch.zeros_like(t) for n, t in params.items()},
                     adamw_init(params), params, tc,
                     decay=None if decay is None else decay(model))
        return {n for n, t in params.items() if not torch.equal(t, before[n])}

    assert port_moved(reference_decay_mask) == moved
    plain = port_moved(None)
    assert "layers.0.rglru.lam" not in plain and plain < moved
    lam = _ref(p, tcfg, "layers.0.rglru.lam")
    lr = float(j_warmup_cosine(jc, 1))
    np.testing.assert_allclose(_ref(new, tcfg, "layers.0.rglru.lam"),
                               lam - lr * jc.weight_decay * lam, rtol=1e-6)


def test_adamw_decreases_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros((3, 1))}
    cfg = AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=0,
                      total_steps=1000, min_lr_ratio=1.0)
    state = adamw_init(params)
    for _ in range(300):
        g = {"w": (params["w"][:, 0] - target)[:, None]}
        params, state, _ = adamw_update(g, state, params, cfg)
    np.testing.assert_allclose(params["w"][:, 0].numpy(), target.numpy(),
                               atol=1e-2)


def test_master_weights_preserve_bf16_params_dtype():
    cfg = configs.get_smoke_config("yi-9b")
    model = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    params = reference_params(model)
    dtypes = {n: t.dtype for n, t in params.items()}
    state = adamw_init(params)
    adamw_update({n: torch.ones(t.shape) for n, t in params.items()}, state,
                 params, AdamWConfig(warmup_steps=0))
    assert {n: t.dtype for n, t in params.items()} == dtypes
    assert torch.bfloat16 in dtypes.values()
    assert all(m.dtype == torch.float32 for m in state["master"].values())


# ------------------------------------------------------------ train step
def test_grad_accum_matches_full_batch():
    """n_microbatches=4 must equal n_microbatches=1 up to fp tolerance."""
    cfg = configs.get_smoke_config("yi-9b").scaled(dtype="float32")
    dc = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    x, y = lm_batches(dc, 0, device=CPU)
    batch = {"inputs": x, "targets": y}
    out = []
    for nm in (1, 4):
        state = init_train_state(torch.Generator().manual_seed(0), cfg, CPU)
        step = make_train_step(cfg, TrainConfig(
            n_microbatches=nm, opt=AdamWConfig(warmup_steps=0)))
        out.append(step(state, batch))
    (s1, m1), (s4, m4) = out
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    for a, b in zip(s1.params.values(), s4.params.values()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=5e-5, rtol=1e-4)


def test_loss_decreases_over_steps():
    cfg = configs.get_smoke_config("yi-9b")
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=50)))
    state = init_train_state(torch.Generator().manual_seed(0), cfg, CPU)
    dc = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    x, y = lm_batches(dc, 0, device=CPU)      # same batch -> must memorize
    losses = []
    for _ in range(12):
        state, m = step(state, {"inputs": x, "targets": y})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses
    assert int(state.step) == int(state.opt_state["step"]) == 12


def test_make_train_step_refuses_a_mesh():
    """A mesh step refuses a state that is not placed on its mesh (the
    mesh step itself is ``tests/test_torch_mesh_train.py``'s)."""
    from repro_torch.models.sharding import Mesh
    cfg = configs.get_smoke_config("yi-9b")
    mesh = Mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    step = make_train_step(cfg, TrainConfig(), mesh=mesh)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, CPU)
    with pytest.raises(ValueError, match="not placed on this step's mesh"):
        step(state, _tb(_batch(cfg, S)))


def assert_masters_close(port, ref_master, cfg, lr):
    """The card check's bar on the masters (see the module docstring)."""
    far = total = 0
    for name, w in port.opt_state["master"].items():
        d = np.abs(w.numpy() - _ref(ref_master, cfg, name))
        assert d.max() <= 2 * lr * (1 + 1e-3), name
        far += int((d > 1e-5).sum())
        total += d.size
    assert far <= 1e-4 * total, (far, total)


def _ref_run(jcfg, p, dc, steps, nm, jstate=None, start=0):
    """The reference's TrainState after ``steps`` jitted steps from
    ``jstate`` (default: fresh AdamW state over ``p``), with its losses."""
    step = jax.jit(j_make_train_step(jcfg, JTrainConfig(
        n_microbatches=nm, opt=JAdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=10)), None))
    if jstate is None:
        jstate = JTrainState(params=p, opt_state=j_adamw_init(p),
                             step=jnp.zeros((), jnp.int32))
    losses, batches = [], []
    for s in range(start, start + steps):
        x, y = (np.asarray(a) for a in j_lm_batches(dc, s))
        batches.append({"inputs": x, "targets": y})
        jstate, m = step(jstate, batches[-1])
        losses.append(float(m["loss"]))
    return jstate, losses, batches


def _port_run(state, cfg, batches, nm):
    step = make_train_step(cfg, TrainConfig(
        n_microbatches=nm, opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                           total_steps=10)))
    losses = []
    for b in batches:
        state, m = step(state, _tb(b))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("arch,nm", [("yi-9b", 1), ("olmoe-1b-7b", 2)])
def test_three_steps_match_reference(arch, nm):
    jcfg, p, tcfg = _case(arch)
    dc = JLMDataConfig(vocab_size=jcfg.vocab_size, seq_len=S, global_batch=4)
    jstate, want, batches = _ref_run(jcfg, p, dc, 3, nm)
    fresh = JTrainState(params=p, opt_state=j_adamw_init(p),
                        step=np.zeros((), np.int32))
    state = train_state_from_reference(
        jax.tree.map(np.asarray, fresh), tcfg, CPU)
    state, got = _port_run(state, tcfg, batches, nm)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert int(state.step) == 3
    assert_masters_close(state, jstate.opt_state["master"], tcfg, 1e-3)
    for key in ("mu", "nu"):
        for name, t in state.opt_state[key].items():
            want_t = _ref(jstate.opt_state[key], tcfg, name)
            np.testing.assert_allclose(t.numpy(), want_t, rtol=0,
                                       atol=1e-4 * np.abs(want_t).max()
                                       + 1e-12, err_msg=f"{key} {name}")


def test_train_state_from_reference_slices_every_leaf():
    jcfg, p, tcfg = _case("recurrentgemma-2b")
    js = JTrainState(params=p, opt_state=j_adamw_init(p),
                     step=np.int32(7))
    js.opt_state["mu"] = jax.tree.map(lambda a: np.asarray(a) + 1.5,
                                      js.opt_state["mu"])
    state = train_state_from_reference(jax.tree.map(np.asarray, js), tcfg,
                                       CPU)
    assert int(state.step) == 7
    for name, prm in state.params.items():
        path, g = reference_key(tcfg, name)
        assert (g is None) == (path[0] != "blocks")
        np.testing.assert_array_equal(prm.detach().numpy(),
                                      _ref(p, tcfg, name))
        np.testing.assert_array_equal(state.opt_state["mu"][name].numpy(),
                                      _ref(js.opt_state["mu"], tcfg, name))
    clone = copy.deepcopy(state)
    assert clone.params.keys() == state.params.keys()
