"""Tensor-parallel compute over "model" (``repro_torch.models.model``'s
mesh routes: each entry of a DP row computes its slice of every split
sublayer) held to the JAX package's own GSPMD programs.

One subprocess over 4 forced host devices jits the reference's sharded
programs on ``jax.sharding.Mesh(devices.reshape(shape), ("data",
"model"))``, whose axes are ``Auto`` (``jax.make_mesh`` gives
``Explicit`` axes, on which the reference's sharded step and prefill
fail on this jax): the per-device dot FLOPs of ``forward`` / ``loss_fn``
/ their gradient at batch 4 x 16 (``repro.launch.hlo_walk.walk`` over
the compiled HLO), and, in fp32 on (2, 2) and (1, 4), ``forward``,
``train_step_fn``, ``prefill`` + 4 ``decode_step``s over a cache placed
by ``cache_spec_tree``, and one ``make_train_step`` on (2, 2) at 1 and 2
microbatches. The weights are the reference's tree drawn with numpy.
The recurrent archs are ``test_torch_tensor_parallel_recurrent.py``'s.

Bars (float32): the walked FLOPs equal; hidden states (after the final
norm) within 1e-5 and logits within 2e-4 (the reference test's bar) max
abs; the loss within 1e-5; each gradient leaf within 1e-5 of its max
abs. The MoE's partials add its K terms of a token across entries in
another order than one ``index_add_`` (exact for the smoke configs' K =
2, a + b either way), so its outputs keep the same 1e-5. The training
step: ``test_torch_mesh_train.py``'s bars. The split CE: 1e-6 of
``chunked_ce``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import chunked_ce as j_chunked_ce
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch.hlo_walk import walk
from repro_torch.models import (LM, decode_step, forward, init_cache,
                                loss_fn, params_from_reference, prefill,
                                train_step_fn)
from repro_torch.models import sharding as shd
from repro_torch.models.model import (ShardedLM, _ce_mean, _ce_sums_split,
                                      _row_params, _shares, _sub_params,
                                      chunked_ce, grad_buffers)
from test_torch_mesh_train import _batch, _check, _full, _sharded_step
from test_torch_train import _case, _ref

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
B, S, P0, STEPS = 4, 16, 12, 4
PARITY = ("yi-9b", "olmoe-1b-7b")
UNDIVIDED = "qwen2-vl-7b"
_REFERENCE = f"UNDIVIDED = {UNDIVIDED!r}\n" + textwrap.dedent("""
import sys
from functools import partial
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_smoke_config
from repro.launch.hlo_walk import walk
from repro.models import init_cache, init_params
from repro.models.model import (decode_step, forward, loss_fn, prefill,
                                train_step_fn)
from repro.models.sharding import cache_spec_tree, make_rules, param_spec_tree
from repro.train import (AdamWConfig, TrainConfig, TrainState, adamw_init,
                         make_train_step)
from repro.train.train_lib import batch_sharding
assert jax.device_count() == 4
d = dict(np.load(sys.argv[1]))
archs, P0, steps = sys.argv[2].split(","), int(sys.argv[3]), int(sys.argv[4])
out = {}

def mesh_of(shape):
    # an Auto mesh: jax.make_mesh's Explicit axes fail the sharded programs
    return Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))

def place(tree, specs, mesh):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                        tree, specs, is_leaf=lambda x: hasattr(x, "shape"))

def path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in kp)

def flat(prefix, tree):
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + path(kp)] = np.asarray(leaf)

# --- the walks: per-device dot FLOPs of the GSPMD programs, smoke configs
mesh = mesh_of((2, 2))
for arch in ("yi-9b", "olmoe-1b-7b", "granite-3-8b", "qwen3-moe-30b-a3b"):
    cfg = get_smoke_config(arch)
    shapes = jax.eval_shape(lambda k: init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rules = make_rules(cfg, mesh)
    ps = jax.tree.map(lambda s, sp: jax.ShapeDtypeStruct(
        s.shape, s.dtype, sharding=NamedSharding(mesh, sp)), shapes,
        param_spec_tree(shapes, cfg, rules))
    bs = batch_sharding(mesh, cfg)
    b = {k: jax.ShapeDtypeStruct((4, 16), jnp.int32, sharding=bs[k])
         for k in ("inputs", "targets")}
    with mesh:
        fns = {"forward": lambda p, b: forward(p, b["inputs"], cfg, rules)[0]}
        if arch == "yi-9b":
            fns["loss_fn"] = lambda p, b: loss_fn(p, b, cfg, rules)[0]
            fns["grad"] = jax.grad(lambda p, b: loss_fn(p, b, cfg, rules)[0])
        for name, fn in fns.items():
            hlo = jax.jit(fn).lower(ps, b).compile().as_text()
            out[f"walk/{arch}/{name}"] = np.float64(walk(hlo).flops)

# --- parity: the sharded programs in fp32 on (2, 2) and (1, 4)
for arch in archs:
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    shapes = jax.eval_shape(lambda k: init_params(k, cfg),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda kp, s: jnp.asarray(d[f"{arch}/p/" + path(kp)]), shapes)
    batch = {k: jnp.asarray(d[f"{arch}/{k}"]) for k in ("inputs", "targets")}
    B = batch["inputs"].shape[0]
    for shape in ((2, 2), (1, 4)):
        mesh = mesh_of(shape)
        rules = make_rules(cfg, mesh)
        tag = f"{arch}/{shape[0]}x{shape[1]}/"
        p = place(params, param_spec_tree(params, cfg, rules), mesh)
        bs = batch_sharding(mesh, cfg)
        b = {k: jax.device_put(v, bs[k]) for k, v in batch.items()}
        with mesh:
            h, (loss, m, g) = jax.jit(lambda p, b: (
                forward(p, b["inputs"], cfg, rules)[0],
                train_step_fn(p, b, cfg, rules)))(p, b)
            out[tag + "hidden"] = np.asarray(h)
            out[tag + "loss"] = np.asarray(loss)
            flat(tag + "grad/", g)
            c0 = init_cache(cfg, B, P0 + steps)
            c = place(c0, cache_spec_tree(c0, cfg, rules), mesh)
            toks = b["inputs"]
            lg, c = jax.jit(partial(prefill, cfg=cfg, rules=rules))(
                p, toks[:, :P0], c)
            out[tag + "prefill"] = np.asarray(lg)
            dec = jax.jit(partial(decode_step, cfg=cfg, rules=rules))
            for t in range(P0, P0 + steps):
                lg, c = dec(p, c, toks[:, t:t + 1], jnp.int32(t))
                out[tag + f"decode/{t}"] = np.asarray(lg)
    # --- one sharded make_train_step on (2, 2) at 1 and 2 microbatches
    mesh = mesh_of((2, 2))
    rules = make_rules(cfg, mesh)
    pspecs = param_spec_tree(params, cfg, rules)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for nm in (1, 2):
        opt0 = adamw_init(params)
        st = TrainState(params=place(params, pspecs, mesh),
                        opt_state={**{k: place(opt0[k], pspecs, mesh)
                                      for k in ("master", "mu", "nu")},
                                   "step": opt0["step"]},
                        step=jnp.zeros((), jnp.int32))
        bs = batch_sharding(mesh, cfg)
        b = {k: jax.device_put(v, bs[k]) for k, v in batch.items()}
        with mesh:
            st, m = jax.jit(make_train_step(cfg, TrainConfig(
                n_microbatches=nm, opt=opt), mesh))(st, b)
        tag = f"{arch}/step{nm}/"
        out[tag + "loss"] = np.asarray(m["loss"])
        flat(tag + "master/", st.opt_state["master"])
        flat(tag + "mu/", st.opt_state["mu"])
# --- heads that "model" does not divide: qwen2-vl's prefill and decode
cfg = get_smoke_config(UNDIVIDED).scaled(dtype="float32")
shapes = jax.eval_shape(lambda k: init_params(k, cfg), jax.random.PRNGKey(0))
params = jax.tree_util.tree_map_with_path(
    lambda kp, s: jnp.asarray(d[f"{UNDIVIDED}/p/" + path(kp)]), shapes)
x = jnp.asarray(d[f"{UNDIVIDED}/x"])
for shape in ((2, 2), (1, 4)):
    mesh = mesh_of(shape)
    rules = make_rules(cfg, mesh)
    tag = f"{UNDIVIDED}/{shape[0]}x{shape[1]}/"
    p = place(params, param_spec_tree(params, cfg, rules), mesh)
    with mesh:
        c0 = init_cache(cfg, x.shape[0], P0 + steps)
        c = place(c0, cache_spec_tree(c0, cfg, rules), mesh)
        lg, c = jax.jit(partial(prefill, cfg=cfg, rules=rules))(
            p, x[:, :P0], c)
        out[tag + "prefill"] = np.asarray(lg)
        dec = jax.jit(partial(decode_step, cfg=cfg, rules=rules))
        for t in range(P0, P0 + steps):
            lg, c = dec(p, c, x[:, t:t + 1], jnp.int32(t))
            out[tag + f"decode/{t}"] = np.asarray(lg)
np.savez(sys.argv[5], **out)
print("OK")
""")


def _flat(tree, prefix):
    return {prefix + "/".join(str(getattr(k, "key", k)) for k in kp):
            np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's walks and sharded programs' outputs (see the
    module docstring), on test_torch_train's weights and
    test_torch_mesh_train's batch."""
    tmp = tmp_path_factory.mktemp("tp")
    data = {}
    for arch in PARITY:
        _, p, tcfg = _case(arch)
        data.update(_flat(p, f"{arch}/p/"))
        data.update({f"{arch}/{k}": v for k, v in _batch(tcfg).items()})
    data.update(_flat(_case(UNDIVIDED)[1], f"{UNDIVIDED}/p/"))
    data[f"{UNDIVIDED}/x"] = _undivided_inputs()
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
         ",".join(PARITY), str(P0), str(STEPS), str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _undivided_inputs():
    """qwen2-vl's float embeddings (B, P0 + STEPS, d) from numpy."""
    d = get_smoke_config(UNDIVIDED).d_model
    return np.random.default_rng(7).standard_normal(
        (B, P0 + STEPS, d)).astype(np.float32)


def _mesh(shape, dev="cpu"):
    return shd.Mesh(shape, ("data", "model"), dev)


def _dry(rules, mesh, batch):
    """Rules that run the first row, and its home: the entry a dry run
    walks (``Mesh.walk``)."""
    row = mesh.rows(("data",), batch)[0]
    return {**rules, "_rows": (row,)}, row.home


def _walks(arch, what):
    """(the first entry's walked FLOPs on a (2, 2) meta mesh, the
    unsharded walk) of ``what`` at batch 4 x 16."""
    cfg = get_smoke_config(arch)
    lm = LM(cfg, "meta")
    toks = torch.zeros((B, S), dtype=torch.int64, device="meta")
    batch = {"inputs": toks, "targets": toks}
    mesh = _mesh((2, 2), "meta")
    rules = shd.make_rules(cfg, mesh)
    sharded = ShardedLM.place(lm, mesh, rules)
    dry, home = _dry(rules, mesh, B)
    fns = {"forward": lambda m, r: forward(m, toks, r),
           "loss_fn": lambda m, r: loss_fn(m, batch, r),
           "grad": lambda m, r: train_step_fn(m, batch, r)}
    fn = fns[what]
    with mesh.walk((home,)):
        entry = walk(fn, sharded, dry).flops
    return entry, walk(fn, lm, None).flops


@pytest.mark.parametrize("arch,what", [
    ("yi-9b", "forward"), ("olmoe-1b-7b", "forward"),
    ("granite-3-8b", "forward"), ("qwen3-moe-30b-a3b", "forward"),
    ("yi-9b", "loss_fn")])
def test_per_entry_walk_equals_reference_per_device(reference, arch, what):
    """One entry's matmul FLOPs equal the reference's per-device dot FLOPs
    of its GSPMD program on the (2, 2) mesh: a quarter of the unsharded
    program's (yi-9b's forward 2,097,152, olmoe's 2,195,456, granite's
    2,490,368, qwen3-moe's 2,588,672; yi-9b's loss 2,621,440)."""
    entry, whole = _walks(arch, what)
    assert entry == reference[f"walk/{arch}/{what}"]
    assert entry * 4 == whole


def test_per_entry_gradient_walk_is_a_quarter(reference):
    """yi-9b's gradient (train_step_fn; remat recomputes each layer): one
    entry walks a quarter of the port's unsharded walk, as the
    reference's per-device gradient is a quarter of its own."""
    entry, whole = _walks("yi-9b", "grad")
    assert entry * 4 == whole
    assert entry == reference["walk/yi-9b/grad"]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", PARITY)
def test_parity_with_reference_sharded_and_port_unsharded(reference, arch,
                                                          shape):
    """forward, train_step_fn (loss, every gradient leaf), prefill and 4
    decode steps on the mesh against the reference's sharded programs
    on the same mesh and the port's unsharded calls."""
    _, p, cfg = _case(arch)
    tag = f"{arch}/{shape[0]}x{shape[1]}/"
    model = params_from_reference(p, cfg, CPU)
    mesh = _mesh(shape)
    rules = shd.make_rules(cfg, mesh)
    sharded = ShardedLM.place(model, mesh, rules)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}

    h = forward(sharded, batch["inputs"], rules)[0]
    h0 = forward(model, batch["inputs"])[0]
    for want in (reference[tag + "hidden"], _np(h0)):
        np.testing.assert_allclose(_np(h), want, rtol=0, atol=1e-5)

    loss, _, grads = train_step_fn(sharded, batch, rules)
    loss0, _, grads0 = train_step_fn(model, batch)
    for want in (float(reference[tag + "loss"]), float(loss0)):
        assert abs(float(loss) - want) <= 1e-5
    for name, g in grads.items():
        got = g.full("cpu").numpy()
        for want in (_ref(_unflat(reference, tag + "grad/"), cfg, name),
                     _np(grads0[name])):
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                       err_msg=name)

    toks = batch["inputs"]
    c0 = init_cache(cfg, B, P0 + STEPS, CPU)
    c1 = init_cache(cfg, B, P0 + STEPS, rules=rules)
    a, c0 = prefill(model, toks[:, :P0], c0)
    b, c1 = prefill(sharded, toks[:, :P0], c1, rules)
    for want in (reference[tag + "prefill"], _np(a)):
        np.testing.assert_allclose(_np(b), want, rtol=0, atol=2e-4)
    for t in range(P0, P0 + STEPS):
        a, c0 = decode_step(model, c0, toks[:, t:t + 1], t)
        b, c1 = decode_step(sharded, c1, toks[:, t:t + 1], t, rules)
        for want in (reference[tag + f"decode/{t}"], _np(a)):
            np.testing.assert_allclose(_np(b), want, rtol=0, atol=2e-4)


def _unflat(reference, prefix):
    """The reference's flattened tree under ``prefix`` as nested dicts."""
    tree = {}
    for k, v in reference.items():
        if k.startswith(prefix):
            node = tree
            *path, leaf = k[len(prefix):].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v
    return tree


@pytest.mark.parametrize("nm", [1, 2])
@pytest.mark.parametrize("arch", PARITY)
def test_sharded_train_step_matches_reference_sharded_step(reference, arch,
                                                           nm):
    """One make_train_step on (2, 2) against the reference's own jitted
    sharded step on the Auto (2, 2) mesh: the loss within 1e-4, the
    moments and masters by test_torch_mesh_train's bars."""
    _, _, cfg = _case(arch)
    state, m = _sharded_step(arch, (2, 2), nm)
    tag = f"{arch}/step{nm}/"
    assert abs(float(m["loss"]) - float(reference[tag + "loss"])) <= 1e-4
    want = {k: {n: _ref(_unflat(reference, f"{tag}{k}/"), cfg, n)
                for n in state.opt_state[k]} for k in ("master", "mu")}
    _check(_full(state), want, "reference sharded")


@pytest.mark.parametrize("S_", [16, 21])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_split_ce_equals_chunked_ce(shape, S_):
    """The CE with the head's vocab columns split over a row's entries
    (per chunk each entry's max and sum of exps, merged into the
    logsumexp on the home) against chunked_ce and the reference's on the
    same hidden states and head: the loss with the z-loss, -1 targets
    and a sequence off the chunks, and its gradient in the hidden states
    and the head, within 1e-6."""
    cfg = get_smoke_config("yi-9b").scaled(dtype="float32")
    rng = np.random.default_rng(S_)
    model = LM(cfg, CPU)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape)
                                     .astype(np.float32)) * 0.3)
    mesh = _mesh(shape)
    rules = shd.make_rules(cfg, mesh)
    sharded = ShardedLM.place(model, mesh, rules)
    row = mesh.rows(("data",), 2)[0]
    hn = rng.standard_normal((2, S_, cfg.d_model)).astype(np.float32)
    tn = rng.integers(0, cfg.vocab_size, (2, S_)).astype(np.int32)
    tn[0, :5] = -1
    tn[1, -3:] = -1
    h0 = torch.from_numpy(hn).requires_grad_(True)
    h1 = torch.from_numpy(hn).requires_grad_(True)
    t = torch.from_numpy(tn)
    bufs = grad_buffers(sharded)
    get = _row_params(sharded, row, bufs)
    got = _ce_mean(*_ce_sums_split(sharded, row, {
        e: h1 for e in row.entries}, t, rules, get))
    want, _ = chunked_ce(h0, model.head(), t, cfg)
    jwant, _ = j_chunked_ce(jnp.asarray(hn), jnp.asarray(
        model.head().detach().numpy()), jnp.asarray(tn), cfg, {})
    assert abs(got.item() - want.item()) <= 1e-6
    assert abs(got.item() - float(jwant)) <= 1e-6
    got.backward()
    want.backward()
    np.testing.assert_allclose(h1.grad.numpy(), h0.grad.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(bufs["lm_head"].full("cpu").numpy(),
                               model.lm_head.grad.numpy(), rtol=0, atol=1e-6)


def test_odd_vocab_keeps_the_head_whole():
    """granite-3-8b's vocab of 255 does not divide "model": the
    embedding and the head stay whole on the row's home, so one entry's
    loss walk adds the whole head's products to its forward walk, and
    the mesh loss equals the unsharded one."""
    cfg = get_smoke_config("granite-3-8b")
    mesh = _mesh((2, 2), "meta")
    rules = shd.make_rules(cfg, mesh)
    assert rules["vocab"] is None
    fwd, _ = _walks("granite-3-8b", "forward")
    loss, _ = _walks("granite-3-8b", "loss_fn")
    assert loss - fwd == 2 * (B // 2) * S * cfg.d_model * cfg.vocab_size
    _, p, tcfg = _case("granite-3-8b")
    model = params_from_reference(p, tcfg, CPU)
    cpu = _mesh((2, 2))
    r = shd.make_rules(tcfg, cpu)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    with torch.no_grad():
        got, _ = loss_fn(ShardedLM.place(model, cpu, r), batch, r)
        want, _ = loss_fn(model, batch)
    assert abs(float(got) - float(want)) <= 1e-5


# each sublayer's output projection: its rows are what an entry's share
# of the sublayer adds up (heads, hidden columns, experts, channels)
OUT_PROJ = {"attn": "wo_attn", "mlp": "wo", "moe": "ewo", "rglru": "w_out",
            "mlstm": "w_out", "slstm": "w_out"}


@pytest.mark.parametrize("arch", ARCHS)
def test_which_sublayers_split(arch):
    """On the production (16, 16) mesh and on (2, 2) every sublayer of
    every kind splits over a row's entries: the rows of its output
    projection that the entries read (heads, MLP columns, experts,
    recurrence channels, a head's value columns) tile it in order, and
    no entry reads the whole of it."""
    cfg = get_config(arch)
    lm = LM(cfg, "meta")
    for shape in ((16, 16), (2, 2)):
        mesh = _mesh(shape, "meta")
        rules = shd.make_rules(cfg, mesh)
        specs = shd.param_spec_tree(lm, cfg, rules)
        row = mesh.rows(("data",), shape[0])[0]
        seen = set()
        for i, layer in enumerate(lm.layers):
            for key, sub in layer.sublayers():
                if key in seen:
                    continue
                seen.add(key)
                prefix = f"layers.{i}.{key}."
                name = prefix + OUT_PROJ[key]
                n = sub.spec[OUT_PROJ[key]][0][0]

                def get(nm, e, region=None, whole=False):
                    return region or shd.model_box(
                        sub.spec[nm[len(prefix):]][0], specs[nm], mesh, e)
                shares = _shares(cfg, row, sub)
                rows = []
                for e in row.entries:
                    if key == "attn" and shares[e][1] == shares[e][0]:
                        continue        # an entry without heads reads none
                    rows.append(_sub_params(get, prefix, sub, e, shares,
                                            cfg)[OUT_PROJ[key]][0])
                assert rows[0][0] == 0 and rows[-1][1] == n, (arch, key)
                assert all(a[1] == b[0] for a, b in zip(rows, rows[1:])), (
                    arch, key, shape, name)
                assert all(hi - lo < n for lo, hi in rows), (arch, key)
                assert len(rows) > 1, (arch, key)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_undivided_heads_decode_over_every_cache_entry(reference, shape):
    """qwen2-vl's 7 heads (28 at full size) do not divide "model", so its
    attention splits them unevenly (4 and 3 on (2, 2), 2, 2, 2 and 1 on
    (1, 4)); its decode over the sequence-sharded cache gathers every
    entry's q heads, takes every entry's slice of the cache, and each
    entry writes the new slots in its range (positions 12-15 fall
    outside the home's on (1, 4)): prefill and 4 decode steps within
    2e-4 of the port's unsharded run and of the reference's sharded
    programs on the same mesh, and the cache's positions equal the
    unsharded cache's."""
    _, p, cfg = _case(UNDIVIDED)
    model = params_from_reference(p, cfg, CPU)
    mesh = _mesh(shape)
    rules = shd.make_rules(cfg, mesh)
    assert rules["heads"] is None and rules["kv_seq"] == "model"
    sharded = ShardedLM.place(model, mesh, rules)
    x = torch.from_numpy(_undivided_inputs())
    tag = f"{UNDIVIDED}/{shape[0]}x{shape[1]}/"
    c0 = init_cache(cfg, B, P0 + STEPS, CPU)
    c1 = init_cache(cfg, B, P0 + STEPS, rules=rules)
    a, c0 = prefill(model, x[:, :P0], c0)
    b, c1 = prefill(sharded, x[:, :P0], c1, rules)
    for want in (reference[tag + "prefill"], _np(a)):
        np.testing.assert_allclose(_np(b), want, rtol=0, atol=2e-4)
    for t in range(P0, P0 + STEPS):
        a, c0 = decode_step(model, c0, x[:, t:t + 1], t)
        b, c1 = decode_step(sharded, c1, x[:, t:t + 1], t, rules)
        for want in (reference[tag + f"decode/{t}"], _np(a)):
            np.testing.assert_allclose(_np(b), want, rtol=0, atol=2e-4,
                                       err_msg=str(t))
    for a, b in zip(c0, c1):
        assert torch.equal(a["pos"], b["pos"].full("cpu"))


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "recurrentgemma-2b"])
def test_recurrent_mixers_split_over_the_row(arch):
    """The recurrent mixers split over a row's entries (RG-LRU by channel
    block, mLSTM and sLSTM by head): on (2, 2) one entry walks a quarter
    of the unsharded forward (xlstm-1.3b has no MLP, so its mixers are
    all it walks), and the mesh forward, loss and every gradient leaf
    hold the fp32 bars against the unsharded calls."""
    entry, whole = _walks(arch, "forward")
    assert entry * 4 == whole
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    _, p, tcfg = _case(arch)
    model = params_from_reference(p, tcfg, CPU)
    mesh = _mesh((2, 2))
    rules = shd.make_rules(tcfg, mesh)
    sharded = ShardedLM.place(model, mesh, rules)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    h = forward(sharded, batch["inputs"], rules)[0]
    h0 = forward(model, batch["inputs"])[0]
    np.testing.assert_allclose(_np(h), _np(h0), rtol=0, atol=1e-5)
    loss, _, grads = train_step_fn(sharded, batch, rules)
    loss0, _, grads0 = train_step_fn(model, batch)
    assert abs(float(loss) - float(loss0)) <= 1e-5
    for name, g in grads.items():
        want = _np(grads0[name])
        np.testing.assert_allclose(g.full("cpu").numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)


def test_replicated_batch_is_computed_once():
    """A batch that does not divide the DP rows is replicated over them,
    as the reference replicates it: forward returns the batch once (not
    once per row), and the loss's gradients are the batch's, not one
    copy per row."""
    _, p, cfg = _case("yi-9b")
    model = params_from_reference(p, cfg, CPU)
    mesh = _mesh((2, 2))
    rules = shd.make_rules(cfg, mesh)
    sharded = ShardedLM.place(model, mesh, rules)
    batch = {k: torch.from_numpy(v[:3]) for k, v in _batch(cfg).items()}
    h = forward(sharded, batch["inputs"], rules)[0]
    h0 = forward(model, batch["inputs"])[0]
    assert h.shape == h0.shape
    np.testing.assert_allclose(_np(h), _np(h0), rtol=0, atol=1e-5)
    loss, m, grads = train_step_fn(sharded, batch, rules)
    loss0, m0, grads0 = train_step_fn(model, batch)
    assert int(m["tokens"]) == int(m0["tokens"]) == 3 * S
    assert abs(float(loss) - float(loss0)) <= 1e-5
    for name, g in grads.items():
        want = _np(grads0[name])
        np.testing.assert_allclose(g.full("cpu").numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)
