"""Sequence-parallel decode (``repro_torch.models.layers.
seq_sharded_decode_attention``) and the mesh routes of ``prefill`` /
``decode_step`` (tensor-parallel over "model") held against the JAX
package's own sharded programs.

The reference's ``tests/test_seq_shard_decode.py`` fails here because it
builds its mesh with ``jax.make_mesh``, whose axes are ``Explicit`` in
this jax: its sharded PREFILL (the concat route over a model-sharded
cache) raises ``ShardingTypeError`` there. On a mesh with ``Auto`` axes
(``jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2), ("data",
"model"))``) the same program runs. So a subprocess over 4 forced host
devices runs, jitted: on ``jax.make_mesh((2, 2), ...)``, the
reference's ``seq_sharded_decode_attention`` on a seq-sharded cache and
its ``decode_step(..., rules)`` over a cache an UNSHARDED prefill filled
and ``cache_spec_tree`` placed; on the ``Auto`` (2, 2) and (1, 4)
meshes, its sharded ``prefill(..., rules)`` and the sharded decode
after it — the reference test's config (2 layers, d 32, 4/2 heads, B 4,
prompt 8, max length 16) — beside its unsharded prefill and decode.

Bars: ``_flash_unnormalized`` 1e-6; the decode attention's output 1e-5
(the merge adds the "model" partials in entry order, an fp32 sum in
another order than the psum's) and its new cache blocks equal; logits
2e-4 (the reference test's own bar); the port's sharded prefill's cache
within 1e-5 of its unsharded prefill's (each entry's projections and
the all-reduce of its partials add in another order) and its positions
equal.
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

from repro.models.config import ModelConfig as JModelConfig
from repro.models.layers import _flash_unnormalized as j_flash_unnormalized
from repro_torch import configs
from repro_torch.models import (ModelConfig, decode_step, init_cache,
                                params_from_reference, prefill)
from repro_torch.models import sharding as shd
from repro_torch.models.layers import (_flash_unnormalized,
                                       seq_sharded_decode_attention)
from repro_torch.models.model import ShardedLM
from test_torch_models import _np_params

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab_size=64, attn_chunk=8, ce_chunk=8,
           dtype="float32")
B, P, STEPS, MAXLEN = 4, 8, 4, 16
CPU = torch.device("cpu")

_REFERENCE = textwrap.dedent("""
    import sys
    from functools import partial
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.models import (ModelConfig, init_params, init_cache,
                              decode_step, prefill)
    from repro.models.layers import seq_sharded_decode_attention
    from repro.models.sharding import make_rules, cache_spec_tree
    assert jax.device_count() == 4
    d = dict(np.load(sys.argv[1]))
    out = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    cfg = ModelConfig(**{k: (int(v) if v.isdigit() else v) for k, v in
                         (kv.split("=") for kv in sys.argv[3].split(","))})

    # --- the decode attention alone, on a seq-sharded cache
    put = lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s))
    cache = {"k": put(d["ck"], P("data", "model")),
             "v": put(d["cv"], P("data", "model")),
             "pos": put(d["cpos"], P("model"))}
    fn = jax.jit(lambda q, c, k, v, p: seq_sharded_decode_attention(
        q, c, k, v, p, cfg, mesh))
    o, c = fn(jnp.asarray(d["q"]), cache, jnp.asarray(d["kn"]),
              jnp.asarray(d["vn"]), jnp.asarray(d["positions"]))
    out["attn_out"] = np.asarray(o)
    for k in ("k", "v", "pos"):
        out["attn_" + k] = np.asarray(c[k])

    # --- the model: unsharded prefill + decode, then the sharded decode
    shapes = jax.eval_shape(lambda k: init_params(k, cfg),
                            jax.random.PRNGKey(0))
    path = lambda kp: "/".join(str(getattr(k, "key", k)) for k in kp)
    params = jax.tree_util.tree_map_with_path(
        lambda kp, s: jnp.asarray(d["p/" + path(kp)]), shapes)
    toks = jnp.asarray(d["toks"])
    P0, steps, maxlen = [int(x) for x in sys.argv[2].split(",")]
    lg, c0 = jax.jit(partial(prefill, cfg=cfg))(
        params, toks[:, :P0], init_cache(cfg, toks.shape[0], maxlen))
    out["prefill"] = np.asarray(lg)
    for k, leaf in jax.tree_util.tree_flatten_with_path(c0)[0]:
        out["cache/" + "/".join(str(getattr(x, "key", x)) for x in k)] = \\
            np.asarray(leaf)
    dec = jax.jit(partial(decode_step, cfg=cfg))
    cu = c0
    for t in range(P0, P0 + steps):
        lg, cu = dec(params, cu, toks[:, t:t + 1], jnp.int32(t))
        out[f"dec/{t}"] = np.asarray(lg)
    rules = make_rules(cfg, mesh)
    specs = cache_spec_tree(c0, cfg, rules)
    cs = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                      c0, specs, is_leaf=lambda x: hasattr(x, "shape"))
    sdec = jax.jit(partial(decode_step, cfg=cfg, rules=rules))
    with mesh:
        for t in range(P0, P0 + steps):
            lg, cs = sdec(params, cs, toks[:, t:t + 1], jnp.int32(t))
            out[f"sdec/{t}"] = np.asarray(lg)
    # --- the sharded prefill and decode on Auto meshes
    for shape in ((2, 2), (1, 4)):
        am = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        rules = make_rules(cfg, am)
        c = init_cache(cfg, toks.shape[0], maxlen)
        c = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(am, s)),
                         c, cache_spec_tree(c, cfg, rules),
                         is_leaf=lambda x: hasattr(x, "shape"))
        tag = f"{shape[0]}x{shape[1]}"
        with am:
            lg, c = jax.jit(partial(prefill, cfg=cfg, rules=rules))(
                params, toks[:, :P0], c)
            out[f"sprefill/{tag}"] = np.asarray(lg)
            sdec = jax.jit(partial(decode_step, cfg=cfg, rules=rules))
            for t in range(P0, P0 + steps):
                lg, c = sdec(params, c, toks[:, t:t + 1], jnp.int32(t))
                out[f"spdec/{tag}/{t}"] = np.asarray(lg)
    np.savez(sys.argv[4], **out)
    print("OK")
""")


def _flat(tree, prefix=""):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(k, "key", k)) for k in kp)] = \
            np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(port cfg, reference params, tokens, the reference's outputs)."""
    tmp = tmp_path_factory.mktemp("seqdec")
    jcfg = JModelConfig(**CFG)
    params = _np_params(jcfg, seed=5)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, CFG["vocab_size"], (B, P + STEPS)).astype(np.int32)
    Kh, hd, H = CFG["n_kv_heads"], 8, CFG["n_heads"]
    cpos = np.full(MAXLEN, -1, np.int32)
    cpos[:11] = np.arange(11)
    data = dict(q=rng.standard_normal((B, 1, H, hd)).astype(np.float32),
                ck=rng.standard_normal((B, MAXLEN, Kh, hd)).astype(np.float32),
                cv=rng.standard_normal((B, MAXLEN, Kh, hd)).astype(np.float32),
                cpos=cpos,
                kn=rng.standard_normal((B, 1, Kh, hd)).astype(np.float32),
                vn=rng.standard_normal((B, 1, Kh, hd)).astype(np.float32),
                positions=np.array([11], np.int32), toks=toks,
                **_flat(params, "p/"))
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cfg_arg = ",".join(f"{k}={v}" for k, v in CFG.items())
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
         f"{P},{STEPS},{MAXLEN}", cfg_arg, str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = dict(np.load(tmp / "out.npz"))
    return ModelConfig(**CFG), params, data, want


def _mesh(shape=(2, 2)):
    return shd.Mesh(shape, ("data", "model"), ["cpu"] * 4)


@pytest.mark.parametrize("S,Skv,chunk", [(1, 16, 8), (1, 13, 8), (3, 8, 16)])
def test_flash_unnormalized_matches_reference(S, Skv, chunk):
    rng = np.random.default_rng(S * 100 + Skv)
    q = rng.standard_normal((2, S, 2, 2, 8)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 2, 8)).astype(np.float32)
    mask = rng.random((2, S, Skv)) < 0.7
    mask[0, 0] = False                       # a row with nothing to attend
    want = j_flash_unnormalized(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask), 0.35,
                                chunk)
    got = _flash_unnormalized(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                              0.35, chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_seq_sharded_decode_attention_matches_reference(case):
    cfg, _, d, want = case
    mesh = _mesh()
    t = {k: torch.from_numpy(d[k]) for k in ("q", "ck", "cv", "cpos", "kn",
                                             "vn", "positions")}
    cache = {"k": shd.Sharded.place(t["ck"], mesh, ("data", "model")),
             "v": shd.Sharded.place(t["cv"], mesh, ("data", "model")),
             "pos": shd.Sharded.place(t["cpos"], mesh, ("model",))}
    moved = {}
    with shd.listen(lambda kind, n: moved.__setitem__(
            kind, moved.get(kind, 0) + n)):
        out, cache = seq_sharded_decode_attention(
            t["q"], cache, t["kn"], t["vn"], t["positions"], cfg, mesh)
    np.testing.assert_allclose(out.numpy(), want["attn_out"], rtol=0,
                               atol=1e-5)
    for k in ("k", "v", "pos"):
        np.testing.assert_array_equal(cache[k].full("cpu").numpy(),
                                      want["attn_" + k])
    # slot 11 lies in the second model entry's half: only its blocks change
    assert torch.equal(cache["pos"].blocks[0], t["cpos"][:8])
    # q, k_new, v_new and pos out to the entries, the partials back, the
    # second row's output to the first
    assert set(moved) == {"collective-permute", "all-reduce", "all-gather"}


def _port_run(model, cfg, toks, rules=None):
    t = torch.from_numpy(toks)
    cache = init_cache(cfg, B, MAXLEN, CPU, rules=rules)
    lg, cache = prefill(model, t[:, :P], cache, rules)
    out, after_prefill = [lg], _gather(cache)
    for s in range(P, P + STEPS):
        lg, cache = decode_step(model, cache, t[:, s:s + 1], s, rules)
        out.append(lg)
    return out, after_prefill


def _gather(cache):
    def leaf(x):
        return x.full("cpu") if isinstance(x, shd.Sharded) else x.clone()
    return [{k: leaf(v) for k, v in c.items()} if isinstance(c, dict)
            else tuple(leaf(v) for v in c) for c in cache]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_prefill_and_decode_match_unsharded_and_reference(case,
                                                                  shape):
    """The reference test's own run on ["cpu"] * 4: the port's sharded
    prefill's cache within 1e-5 of its unsharded prefill's (positions
    equal), and its logits and the decode logits within 2e-4 of the
    port's unsharded run, of the reference's unsharded run and of the
    reference's own sharded prefill and decode on the same mesh."""
    cfg, params, d, want = case
    model = params_from_reference(params, cfg, CPU)
    mesh = _mesh(shape)
    rules = shd.make_rules(cfg, mesh)
    sharded = ShardedLM.place(model, mesh)
    base, base_cache = _port_run(model, cfg, d["toks"])
    got, got_cache = _port_run(sharded, cfg, d["toks"], rules)
    for a, b in zip(base_cache, got_cache):
        assert torch.equal(a["pos"], b["pos"])
        for k in ("k", "v"):
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
    tag = f"{shape[0]}x{shape[1]}"
    for w in (base[0].numpy(), want["prefill"], want[f"sprefill/{tag}"]):
        np.testing.assert_allclose(got[0].numpy(), w, rtol=0, atol=2e-4)
    for i, s in enumerate(range(P, P + STEPS)):
        for w in (base[i + 1].numpy(), want[f"dec/{s}"],
                  want[f"spdec/{tag}/{s}"]):
            np.testing.assert_allclose(got[i + 1].numpy(), w, rtol=0,
                                       atol=2e-4)
    # the unsharded prefill's cache == the reference's
    for i, c in enumerate(base_cache):
        for k, v in c.items():
            np.testing.assert_allclose(
                v.numpy(), want[f"cache/blocks/b0/{k}"][i], rtol=0,
                atol=1e-5)


def test_sharded_decode_matches_reference_sharded_decode(case):
    """After an unsharded prefill, the port's decode_step over the cache
    placed by cache_spec_tree against the reference's jitted sharded
    decode_step (whose params are unsharded: the ShardedLM's blocks
    gather to the same values)."""
    cfg, params, d, want = case
    model = params_from_reference(params, cfg, CPU)
    mesh = _mesh()
    rules = shd.make_rules(cfg, mesh)
    sharded = ShardedLM.place(model, mesh)
    t = torch.from_numpy(d["toks"])
    cache = init_cache(cfg, B, MAXLEN, CPU)
    prefill(model, t[:, :P], cache)
    cache = shd.shard_cache(cache, cfg, rules)
    assert cache[0]["k"].spec == ("data", "model", None, None)
    for s in range(P, P + STEPS):
        lg, cache = decode_step(sharded, cache, t[:, s:s + 1], s, rules)
        np.testing.assert_allclose(lg.numpy(), want[f"sdec/{s}"], rtol=0,
                                   atol=2e-4)


def test_mesh_call_refuses_a_plain_lm(case):
    """With mesh rules, the model must be a ShardedLM: a plain LM is
    refused by prefill and decode_step alike."""
    cfg, params, d, _ = case
    model = params_from_reference(params, cfg, CPU)
    rules = shd.make_rules(cfg, _mesh())
    t = torch.from_numpy(d["toks"])
    cache = init_cache(cfg, B, MAXLEN, CPU, rules=rules)
    with pytest.raises(ValueError, match="ShardedLM"):
        prefill(model, t[:, :P], cache, rules)
    with pytest.raises(ValueError, match="ShardedLM"):
        decode_step(model, cache, t[:, P:P + 1], P, rules)


def test_windowed_ring_cache_stays_whole_on_seq():
    """recurrentgemma's local attention keeps its ring (window 16) whole
    along seq over the mesh: its cache is batch-sharded only, the
    prefill past the window and the decode steps run the gathered route,
    and they equal the unsharded run."""
    cfg = configs.get_smoke_config("recurrentgemma-2b").scaled(
        dtype="float32")
    from repro_torch.models import init_params
    model = init_params(cfg, torch.Generator().manual_seed(3), CPU)
    mesh = _mesh()
    rules = shd.make_rules(cfg, mesh)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 24)))
    c0 = init_cache(cfg, 4, 32, CPU)
    c1 = init_cache(cfg, 4, 32, rules=rules)
    ring = [c for c in c1 if isinstance(c, dict) and "k" in c]
    assert ring and all(c["k"].spec == ("data", None, None, None)
                        and c["pos"].spec == (None,) for c in ring)
    sharded = ShardedLM.place(model, mesh)
    a, c0 = prefill(model, toks[:, :20], c0)
    b, c1 = prefill(sharded, toks[:, :20], c1, rules)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    for s in range(20, 24):
        a, c0 = decode_step(model, c0, toks[:, s:s + 1], s)
        b, c1 = decode_step(sharded, c1, toks[:, s:s + 1], s, rules)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-4)
    for x, y in zip(_gather(c0), _gather(c1)):
        for k in (x if isinstance(x, dict) else range(len(x))):
            np.testing.assert_allclose(x[k].numpy(), y[k].numpy(), rtol=0,
                                       atol=1e-5)
