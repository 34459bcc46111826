"""Tensor-parallel compute in the recurrent mixers (the RG-LRU by
channel block, the mLSTM and sLSTM by head or by a head's value columns)
and in attention whose heads "model" does not divide, held to the JAX
package's own GSPMD programs.

One subprocess over 4 forced host devices jits the reference on
``jax.sharding.Mesh(devices.reshape(shape), ("data", "model"))`` (``Auto``
axes, as ``test_torch_tensor_parallel.py`` does) and walks the compiled
HLO (``repro.launch.hlo_walk.walk``): the one-device ``forward`` of the
ten smoke archs at batch 4 x 16 (hubert and qwen2-vl on float inputs),
the per-device ``forward`` of recurrentgemma-2b, xlstm-1.3b and
qwen2-vl-7b on (2, 2) and (1, 4); and, in fp32 on (2, 2) and (1, 4) for
recurrentgemma-2b and xlstm-1.3b, ``forward``, ``train_step_fn``,
``prefill`` of 16 tokens (the smoke's mLSTM chunk, off the reference's
padding finding) + 4 ``decode_step``s over a cache placed by
``cache_spec_tree``; and one ``make_train_step`` on (2, 2) at 1 and 2
microbatches. The weights are the reference's tree drawn with numpy.

Bars (float32, ``test_torch_tensor_parallel.py``'s): the walked FLOPs
equal (or, where the reference's GSPMD splits less, no more); hidden
states within 1e-5, logits within 2e-4, the loss within 1e-5, each
gradient leaf within 1e-5 of its max abs; the training step by
``test_torch_mesh_train.py``'s bars. The port's unsharded xlstm-1.3b is
itself 1.09e-5 off the reference's one-device forward on these inputs,
and its gradients up to ~8e-6 of a leaf's max abs
(``test_torch_models.py`` and ``test_torch_train.py`` hold them at 1e-4),
so against the reference's sharded programs the hidden states and each
gradient leaf are held to their bar beyond the port's unsharded
difference from the reference's one-device program on the same leaf;
against the port's unsharded calls, to the bar flat. Every replica of a
recurrent state
(the cache keeps them whole over "model") holds the same bits as the
others after each step, and each is within 1e-5 (of the leaf's max abs
where that is above 1) of the unsharded state.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.launch.hlo_walk import walk
from repro_torch.models import (LM, decode_step, forward, init_cache,
                                params_from_reference, prefill,
                                train_step_fn)
from repro_torch.models import sharding as shd
from repro_torch.models.model import (ShardedLM, _row_params, _shares,
                                      _sub_params)
from repro_torch.models.recurrent import rglru_entries, slstm_entries
from test_torch_mesh_train import _batch, _check, _full, _sharded_step
from test_torch_train import _case, _ref

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
B, S, P0, STEPS = 4, 16, 16, 4
RECURRENT = ("recurrentgemma-2b", "xlstm-1.3b")
WALKED = RECURRENT + ("qwen2-vl-7b",)
SHAPES = ((2, 2), (1, 4))
_REFERENCE = textwrap.dedent("""
import sys
from functools import partial
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import ARCHS, get_smoke_config
from repro.launch.hlo_walk import walk
from repro.models import init_cache, init_params
from repro.models.model import (decode_step, forward, prefill,
                                train_step_fn)
from repro.models.sharding import cache_spec_tree, make_rules, param_spec_tree
from repro.train import (AdamWConfig, TrainConfig, TrainState, adamw_init,
                         make_train_step)
from repro.train.train_lib import batch_sharding
assert jax.device_count() == 4
d = dict(np.load(sys.argv[1]))
archs, walked = sys.argv[2].split(","), sys.argv[3].split(",")
P0, steps = int(sys.argv[4]), int(sys.argv[5])
out = {}

def mesh_of(shape):
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

def inputs(cfg, sharding=None):
    shape = (4, 16, cfg.d_model) if cfg.embedding_inputs else (4, 16)
    dt = jnp.float32 if cfg.embedding_inputs else jnp.int32
    return jax.ShapeDtypeStruct(shape, dt, sharding=sharding)

# --- the walks: dot FLOPs of forward at batch 4 x 16, smoke configs
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    shapes = jax.eval_shape(lambda k: init_params(k, cfg),
                            jax.random.PRNGKey(0))
    fn = jax.jit(lambda p, x: forward(p, x, cfg)[0])
    out[f"walk/{arch}/1x1"] = np.float64(walk(
        fn.lower(shapes, inputs(cfg)).compile().as_text()).flops)
    if arch not in walked:
        continue
    for shape in ((2, 2), (1, 4)):
        mesh = mesh_of(shape)
        rules = make_rules(cfg, mesh)
        ps = jax.tree.map(lambda s, sp: jax.ShapeDtypeStruct(
            s.shape, s.dtype, sharding=NamedSharding(mesh, sp)), shapes,
            param_spec_tree(shapes, cfg, rules))
        x = inputs(cfg, batch_sharding(mesh, cfg)["inputs"])
        with mesh:
            hlo = jax.jit(lambda p, x: forward(p, x, cfg, rules)[0]).lower(
                ps, x).compile().as_text()
        out[f"walk/{arch}/{shape[0]}x{shape[1]}"] = np.float64(
            walk(hlo).flops)

# --- parity: the sharded programs in fp32 on (2, 2) and (1, 4)
for arch in archs:
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    shapes = jax.eval_shape(lambda k: init_params(k, cfg),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda kp, s: jnp.asarray(d[f"{arch}/p/" + path(kp)]), shapes)
    batch = {k: jnp.asarray(d[f"{arch}/{k}"]) for k in ("inputs", "targets")}
    toks = jnp.asarray(d[f"{arch}/toks"])
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    h, (loss, m, g) = jax.jit(lambda p, b: (
        forward(p, b["inputs"], cfg)[0], train_step_fn(p, b, cfg)))(
        params, batch)
    out[f"{arch}/1x1/hidden"] = np.asarray(h)
    flat(f"{arch}/1x1/grad/", g)
    for shape in ((2, 2), (1, 4)):
        mesh = mesh_of(shape)
        rules = make_rules(cfg, mesh)
        tag = f"{arch}/{shape[0]}x{shape[1]}/"
        pspecs = param_spec_tree(params, cfg, rules)
        p = place(params, pspecs, mesh)
        bs = batch_sharding(mesh, cfg)
        b = {k: jax.device_put(v, bs[k]) for k, v in batch.items()}
        with mesh:
            h, (loss, m, g) = jax.jit(lambda p, b: (
                forward(p, b["inputs"], cfg, rules)[0],
                train_step_fn(p, b, cfg, rules)))(p, b)
            out[tag + "hidden"] = np.asarray(h)
            out[tag + "loss"] = np.asarray(loss)
            flat(tag + "grad/", g)
            c0 = init_cache(cfg, 4, P0 + steps)
            c = place(c0, cache_spec_tree(c0, cfg, rules), mesh)
            t = jax.device_put(toks, bs["inputs"])
            lg, c = jax.jit(partial(prefill, cfg=cfg, rules=rules))(
                p, t[:, :P0], c)
            out[tag + "prefill"] = np.asarray(lg)
            dec = jax.jit(partial(decode_step, cfg=cfg, rules=rules))
            for s in range(P0, P0 + steps):
                lg, c = dec(p, c, t[:, s:s + 1], jnp.int32(s))
                out[tag + f"decode/{s}"] = np.asarray(lg)
            flat(tag + "cache/", c)
        for nm in ((1, 2) if shape == (2, 2) else ()):
            opt0 = adamw_init(params)
            st = TrainState(params=p,
                            opt_state={**{k: place(opt0[k], pspecs, mesh)
                                          for k in ("master", "mu", "nu")},
                                       "step": opt0["step"]},
                            step=jnp.zeros((), jnp.int32))
            with mesh:
                st, m = jax.jit(make_train_step(cfg, TrainConfig(
                    n_microbatches=nm, opt=opt), mesh))(st, b)
            stag = f"{tag}step{nm}/"
            out[stag + "loss"] = np.asarray(m["loss"])
            flat(stag + "master/", st.opt_state["master"])
            flat(stag + "mu/", st.opt_state["mu"])
np.savez(sys.argv[6], **out)
print("OK")
""")


def _flat(tree, prefix):
    return {prefix + "/".join(str(getattr(k, "key", k)) for k in kp):
            np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tokens(cfg):
    """The prompt and decode tokens (B, P0 + STEPS) from numpy."""
    return np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, P0 + STEPS)).astype(np.int32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's walks and sharded programs' outputs (see the
    module docstring), on test_torch_train's weights and
    test_torch_mesh_train's batch."""
    tmp = tmp_path_factory.mktemp("tpr")
    data = {}
    for arch in RECURRENT:
        _, p, tcfg = _case(arch)
        data.update(_flat(p, f"{arch}/p/"))
        data.update({f"{arch}/{k}": v for k, v in _batch(tcfg).items()})
        data[f"{arch}/toks"] = _tokens(tcfg)
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
         ",".join(RECURRENT), ",".join(WALKED), str(P0), str(STEPS),
         str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _inputs(cfg):
    if cfg.embedding_inputs:
        return torch.zeros((B, S, cfg.d_model), device="meta")
    return torch.zeros((B, S), dtype=torch.int64, device="meta")


def _walk(arch, shape=None):
    """forward's walked FLOPs at batch 4 x 16: unsharded, or one entry's
    on a ``shape`` mesh of ``meta`` entries (the first row's home)."""
    cfg = get_smoke_config(arch)
    lm = LM(cfg, "meta")
    x = _inputs(cfg)
    if shape is None:
        return walk(lambda: forward(lm, x)).flops
    mesh = shd.Mesh(shape, ("data", "model"), "meta")
    rules = shd.make_rules(cfg, mesh)
    sharded = ShardedLM.place(lm, mesh, rules)
    row = mesh.rows(("data",), B)[0]
    with mesh.walk((row.home,)):
        return walk(lambda: forward(sharded, x, {**rules,
                                                 "_rows": (row,)})).flops


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_walk_equals_reference_one_device(reference, arch):
    """The port's unsharded forward walks the reference's one-device HLO
    FLOPs: xlstm-1.3b's mLSTM no longer updates C and n after the last
    chunk when the state is dropped (13,242,368, was 14,053,376), as
    XLA drops that dead code from the reference's program."""
    assert _walk(arch) == reference[f"walk/{arch}/1x1"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", WALKED)
def test_per_entry_walk_against_reference_per_device(reference, arch,
                                                     shape):
    """One entry's forward FLOPs on the mesh: on (2, 2) the recurrent
    archs' equal the reference's per-device GSPMD walk, a quarter of
    the unsharded (recurrentgemma-2b 7,012,352, xlstm-1.3b 3,310,592);
    elsewhere no more than the reference's (on (1, 4) its GSPMD keeps
    the smoke's 2 mLSTM heads whole; qwen2-vl's 7 heads split 4/3 and
    2/2/2/1 here)."""
    tag = f"walk/{arch}/{shape[0]}x{shape[1]}"
    entry = _walk(arch, shape)
    if arch in RECURRENT and shape == (2, 2):
        assert entry == reference[tag]
        assert entry * 4 == reference[f"walk/{arch}/1x1"]
    else:
        assert entry <= reference[tag]


def _np(t):
    return t.detach().float().numpy()


def _unflat(reference, prefix):
    tree = {}
    for k, v in reference.items():
        if k.startswith(prefix):
            node = tree
            *path, leaf = k[len(prefix):].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v
    return tree


def _check_states(unsharded, sharded, what):
    """Every replica of each recurrent leaf equals the others' bits and
    the unsharded state's region (1e-5 of max(1, its max abs))."""
    for i, (a, b) in enumerate(zip(unsharded, sharded)):
        if isinstance(a, dict) and "k" in a:
            continue
        for k in (a if isinstance(a, dict) else range(len(a))):
            want, sh = a[k], b[k]
            for box, holders in sh.holders.items():
                for e in holders[1:]:
                    assert torch.equal(sh.blocks[e], sh.blocks[holders[0]]), (
                        what, i, k, e)
                region = want[tuple(slice(lo, hi) for lo, hi in box)]
                tol = 1e-5 * max(1.0, float(region.abs().max()))
                np.testing.assert_allclose(_np(sh.blocks[holders[0]]),
                                           _np(region), rtol=0, atol=tol,
                                           err_msg=f"{what} layer {i} {k}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", RECURRENT)
def test_parity_with_reference_sharded_and_port_unsharded(reference, arch,
                                                          shape):
    """forward, train_step_fn (loss, every gradient leaf), prefill of 16
    tokens and 4 decode steps on the mesh against the reference's
    sharded programs on the same mesh and the port's unsharded calls;
    after the prefill and each decode step every replica of each
    recurrent state against the unsharded state, and after the last the
    reference's sharded cache."""
    _, p, cfg = _case(arch)
    tag = f"{arch}/{shape[0]}x{shape[1]}/"
    model = params_from_reference(p, cfg, CPU)
    mesh = shd.Mesh(shape, ("data", "model"), "cpu")
    rules = shd.make_rules(cfg, mesh)
    sharded = ShardedLM.place(model, mesh, rules)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}

    h = forward(sharded, batch["inputs"], rules)[0]
    h0 = forward(model, batch["inputs"])[0]
    np.testing.assert_allclose(_np(h), _np(h0), rtol=0, atol=1e-5)
    own = float(np.abs(_np(h0) - reference[f"{arch}/1x1/hidden"]).max())
    np.testing.assert_allclose(_np(h), reference[tag + "hidden"], rtol=0,
                               atol=1e-5 + own)

    loss, _, grads = train_step_fn(sharded, batch, rules)
    loss0, _, grads0 = train_step_fn(model, batch)
    for want in (float(reference[tag + "loss"]), float(loss0)):
        assert abs(float(loss) - want) <= 1e-5
    ref_grads = _unflat(reference, tag + "grad/")
    ref_one = _unflat(reference, f"{arch}/1x1/grad/")
    for name, g in grads.items():
        got, port = g.full("cpu").numpy(), _np(grads0[name])
        bar = 1e-5 * float(np.abs(port).max())
        np.testing.assert_allclose(got, port, rtol=0, atol=bar, err_msg=name)
        own = float(np.abs(port - _ref(ref_one, cfg, name)).max())
        np.testing.assert_allclose(got, _ref(ref_grads, cfg, name), rtol=0,
                                   atol=bar + own, err_msg=name)

    toks = torch.from_numpy(_tokens(cfg))
    c0 = init_cache(cfg, B, P0 + STEPS, CPU)
    c1 = init_cache(cfg, B, P0 + STEPS, rules=rules)
    a, c0 = prefill(model, toks[:, :P0], c0)
    b, c1 = prefill(sharded, toks[:, :P0], c1, rules)
    for want in (reference[tag + "prefill"], _np(a)):
        np.testing.assert_allclose(_np(b), want, rtol=0, atol=2e-4)
    _check_states(c0, c1, "prefill")
    for t in range(P0, P0 + STEPS):
        a, c0 = decode_step(model, c0, toks[:, t:t + 1], t)
        b, c1 = decode_step(sharded, c1, toks[:, t:t + 1], t, rules)
        for want in (reference[tag + f"decode/{t}"], _np(a)):
            np.testing.assert_allclose(_np(b), want, rtol=0, atol=2e-4,
                                       err_msg=str(t))
        _check_states(c0, c1, f"decode {t}")
    ref_cache = _unflat(reference, tag + "cache/")
    for i, layer in enumerate(c1):
        if isinstance(layer, dict) and "k" in layer:
            continue
        for k in (layer if isinstance(layer, dict) else range(len(layer))):
            want = np.asarray(_ref_cache(ref_cache, cfg, i)[str(k)])
            got = layer[k].full("cpu").numpy()
            tol = 1e-5 * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=f"layer {i} {k}")


def _ref_cache(tree, cfg, i):
    """The reference cache's leaves of the port's layer i (its
    ``blocks/b{j}`` at group g, or ``rem/r{j}``), by leaf name."""
    g, j = divmod(i, len(cfg.block_pattern))
    if g < cfg.n_groups:
        return {k: v[g] for k, v in tree["blocks"][f"b{j}"].items()}
    return tree["rem"][f"r{j}"]


@pytest.mark.parametrize("nm", [1, 2])
@pytest.mark.parametrize("arch", RECURRENT)
def test_sharded_train_step_matches_reference_sharded_step(reference, arch,
                                                           nm):
    """One make_train_step on (2, 2) against the reference's own jitted
    sharded step on the same Auto mesh: the loss within 1e-4, the
    moments and masters by test_torch_mesh_train's bars."""
    _, _, cfg = _case(arch)
    state, m = _sharded_step(arch, (2, 2), nm)
    tag = f"{arch}/2x2/step{nm}/"
    assert abs(float(m["loss"]) - float(reference[tag + "loss"])) <= 1e-4
    want = {k: {n: _ref(_unflat(reference, f"{tag}{k}/"), cfg, n)
                for n in state.opt_state[k]} for k in ("master", "mu")}
    _check(_full(state), want, "reference sharded")


@pytest.mark.parametrize("arch,shape", [("recurrentgemma-2b", (2, 2)),
                                        ("xlstm-1.3b", (1, 4))])
def test_walk_counts_the_mixers_gathers(arch, shape):
    """Inside ``Mesh.walk`` one entry counts the moves its mixer makes
    with the row's others: the RG-LRU's conv output all-gathered over
    the row (its block sent to, and each other's received from, the
    m - 1 others), and on (1, 4), where two entries share each of the
    smoke's 2 sLSTM heads, the h columns all-gathered within the head
    before each of the S steps — and nothing else."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    mesh = shd.Mesh(shape, ("data", "model"), "meta")
    rules = shd.make_rules(cfg, mesh)
    sharded = ShardedLM.place(LM(cfg, "meta"), mesh, rules)
    row = mesh.rows(("data",), B)[0]
    kind = "rglru" if arch == "recurrentgemma-2b" else "slstm"
    i = next(i for i, k in enumerate(sharded.skeleton.layers)
             if k.kind == kind)
    sub = getattr(sharded.skeleton.layers[i], kind)
    shares = _shares(cfg, row, sub)
    ps = {row.home: _sub_params(_row_params(sharded, row, None),
                                f"layers.{i}.{kind}.", sub, row.home,
                                shares, cfg)}
    xs = {row.home: torch.zeros((row.size, S, cfg.d_model), device="meta")}
    fn = rglru_entries if kind == "rglru" else slstm_entries
    with mesh.walk((row.home,)):
        w = walk(fn, xs, ps, cfg, mesh, row, shares)
    lo, hi = shares[row.home][-2:]
    block = row.size * S * (hi - lo) * 4            # fp32
    if kind == "rglru":
        want = 2 * (len(row.entries) - 1) * block
    else:
        sharers = sum(shares[e][0] == shares[row.home][0]
                      for e in row.entries)
        want = 2 * (sharers - 1) * block
        assert sharers == 2
    assert w.collectives["all-gather"] == want
    assert w.collective_bytes == want


def test_q_heads_straddling_kv_groups_unevenly():
    """10 heads in 2 kv groups of 5 on (1, 4) split 3/3/2/2: entry 1's
    heads 3-5 read kv heads 0, 0 and 1, which the grouped einsum cannot
    say, so its k and v are taken per q head (``layers._kv_index``);
    the forward, the loss and its gradients, and a prefill (the cached
    route) with 4 sequence-parallel decode steps against the unsharded
    port, and the cache's k, v and positions after them."""
    from repro_torch.models import init_params
    from repro_torch.models.layers import _kv_index, entry_heads
    cfg = get_smoke_config("yi-9b").scaled(n_heads=10, n_kv_heads=2,
                                           head_dim=8, dtype="float32")
    mesh = shd.Mesh((1, 4), ("data", "model"), "cpu")
    row = mesh.rows(("data",), B)[0]
    heads = entry_heads(cfg, row)
    assert [h[:2] for h in heads.values()] == [(0, 3), (3, 6), (6, 8),
                                                (8, 10)]
    assert _kv_index(cfg, heads[1]) == [0, 0, 1]
    assert all(_kv_index(cfg, heads[e]) is None for e in (0, 2, 3))
    model = init_params(cfg, torch.Generator().manual_seed(5), CPU)
    rules = shd.make_rules(cfg, mesh)
    sharded = ShardedLM.place(model, mesh, rules)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    h = forward(sharded, batch["inputs"], rules)[0]
    np.testing.assert_allclose(_np(h), _np(forward(model, batch["inputs"])[0]),
                               rtol=0, atol=1e-5)
    loss, _, grads = train_step_fn(sharded, batch, rules)
    loss0, _, grads0 = train_step_fn(model, batch)
    assert abs(float(loss) - float(loss0)) <= 1e-5
    for name, g in grads.items():
        want = _np(grads0[name])
        np.testing.assert_allclose(g.full("cpu").numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)
    toks = torch.from_numpy(_tokens(cfg))
    c0 = init_cache(cfg, B, P0 + STEPS, CPU)
    c1 = init_cache(cfg, B, P0 + STEPS, rules=rules)
    a, c0 = prefill(model, toks[:, :P0], c0)
    b, c1 = prefill(sharded, toks[:, :P0], c1, rules)
    np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=2e-4)
    for t in range(P0, P0 + STEPS):
        a, c0 = decode_step(model, c0, toks[:, t:t + 1], t)
        b, c1 = decode_step(sharded, c1, toks[:, t:t + 1], t, rules)
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=2e-4,
                                   err_msg=str(t))
    for x, y in zip(c0, c1):
        assert torch.equal(x["pos"], y["pos"].full("cpu"))
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(y[k].full("cpu")), _np(x[k]),
                                       rtol=0, atol=1e-5)
