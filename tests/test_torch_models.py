"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
held against the JAX package on the CPU: the same parameters (the
reference's tree carried over by ``params_from_reference``) and the same
numpy inputs through both.

Bars: float32 max abs <= 1e-4 (hidden states, logits, every cache leaf).
bfloat16: the two frameworks round elementwise ops differently (XLA's
bf16 logistic is not correctly rounded and its tanh-GELU runs step by
step on bf16 constants; torch computes each op in fp32 and rounds once),
so bf16 is held as an accuracy class: against the fp32 run of the same
weights, the port's max abs error is at most 1.5x the reference's plus
0.02 (a bf16 ulp near 4), and its mean abs error at most 1.5x the
reference's plus 0.01. Measured on these inputs: max ratio 1.24
(recurrentgemma's hidden states, 0.115 against 0.093), mean ratio 1.15;
olmoe's decode logits are 1.57 off fp32 in both packages, a router
flipped by bf16 rounding either way.

Each arch's parameters are made once per module; the reference's
``forward``, ``prefill`` and ``decode_step`` are jitted whole.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro.models.config import active_param_count as j_active
from repro.models.config import param_count as j_count
from repro.models.layers import flash_attention as j_flash
from repro_torch import configs
from repro_torch.models import (LM, decode_step, forward, init_cache,
                                init_params, params_from_reference, prefill)
from repro_torch.models.config import active_param_count, param_count
from repro_torch.models.layers import flash_attention

CPU = torch.device("cpu")
DECODERS = [a for a in configs.ARCHS
            if configs.shape_applicable(a, "decode_32k")[0]]
B, S, GEN = 2, 24, 4


def _cfgs(arch, dtype=None):
    j, t = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    if dtype:
        j, t = j.scaled(dtype=dtype), t.scaled(dtype=dtype)
    return j, t


def _np_tree(tree, dtype=None):
    return jax.tree.map(
        lambda a: np.asarray(a if dtype is None else a.astype(dtype)), tree)


def _np_params(jcfg, seed):
    """Parameters of the reference's tree structure (``jax.eval_shape``)
    drawn with numpy: norms 1, RG-LRU biases 0 and lam 0.5, the embedding
    normal x 0.02, the conv x 0.1, every other weight normal x
    1/sqrt(fan_in)."""
    shapes = jax.eval_shape(lambda k: j_init(k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("norm", "final_norm", "lam", "ba", "bx"):
            a = np.full(s.shape, {"lam": 0.5, "ba": 0.0, "bx": 0.0}.get(
                name, 1.0), np.float32)
        else:
            std = {"embedding": 0.02, "conv_w": 0.1}.get(
                name, 1.0 / np.sqrt(s.shape[-2]))
            a = (rng.standard_normal(s.shape) * std).astype(np.float32)
        return np.asarray(jnp.asarray(a, s.dtype))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _case(arch, dtype):
    """(reference cfg, params as numpy, port cfg, port model)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    p = _np_params(jcfg, seed=2)
    return jcfg, p, tcfg, params_from_reference(p, tcfg, CPU)


@functools.lru_cache(maxsize=None)
def _truth_model(arch):
    """The port in fp32 on the bf16 case's weights, upcast."""
    _, p, _, _ = _case(arch, "bfloat16")
    _, tcfg = _cfgs(arch, "float32")
    return params_from_reference(_np_tree(p, np.float32), tcfg, CPU)


def _inputs(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        return rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _t(x):
    return torch.from_numpy(x).long() if x.dtype == np.int32 \
        else torch.from_numpy(x)


def _f32(t):
    return t.detach().float().numpy()


def _ref_layers(cache, cfg):
    """The reference's cache tree as the port's per-layer list."""
    n, out = len(cfg.block_pattern), []
    for i in range(cfg.n_layers):
        g, b = divmod(i, n)
        if g < cfg.n_groups:
            out.append(jax.tree.map(lambda a: np.asarray(a[g]),
                                    cache["blocks"][f"b{b}"]))
        else:
            out.append(_np_tree(cache["rem"][f"r{b}"]))
    return out


def _leaves(entry):
    return [entry[k] for k in sorted(entry)] if isinstance(entry, dict) \
        else list(entry)


def _bf16_class(port, ref, truth):
    dp, dr = np.abs(port - truth), np.abs(ref - truth)
    assert dp.max() <= 1.5 * dr.max() + 0.02, (dp.max(), dr.max())
    assert dp.mean() <= 1.5 * dr.mean() + 0.01, (dp.mean(), dr.mean())


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_configs_and_param_counts_match_reference(arch):
    for getter in ("get_config", "get_smoke_config"):
        j = getattr(jconfigs, getter)(arch)
        t = getattr(configs, getter)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert param_count(t) == j_count(j)
        assert active_param_count(t) == j_active(j)
        assert (t.hd, t.n_groups, t.n_remainder) == (j.hd, j.n_groups,
                                                     j.n_remainder)


def test_registry_matches_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.SHAPES == jconfigs.SHAPES
    assert configs.SUBQUADRATIC == jconfigs.SUBQUADRATIC
    assert configs.ENCODER_ONLY == jconfigs.ENCODER_ONLY
    assert configs.cells() == jconfigs.cells()


# ------------------------------------------------------------ forward
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_forward_float32(arch):
    jcfg, p, _, model = _case(arch, "float32")
    x = _inputs(jcfg, S)
    h, _, aux = jax.jit(lambda p, x: j_forward(p, x, jcfg))(p, x)
    with torch.no_grad():
        ht, cache, auxt = forward(model, _t(x))
    assert cache is None and ht.dtype == torch.float32
    np.testing.assert_allclose(_f32(ht), np.asarray(h), atol=1e-4, rtol=0)
    assert abs(float(auxt) - float(aux)) <= 1e-4


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_forward_bfloat16(arch):
    jcfg, p, _, model = _case(arch, "bfloat16")
    x = _inputs(jcfg, S)
    h = jax.jit(lambda p, x: j_forward(p, x, jcfg)[0])(p, x)
    with torch.no_grad():
        ht = forward(model, _t(x))[0]
        truth = forward(_truth_model(arch), _t(x))[0]
    assert ht.dtype == torch.bfloat16
    _bf16_class(_f32(ht), np.asarray(h, np.float32), _f32(truth))


# ------------------------------------------------------------ decode
def _prompt_len(cfg):
    # the mLSTM archs at a whole number of chunks: there the reference's
    # carried state is the true one (see test_mlstm_padding_finding)
    return 2 * cfg.attn_chunk if "mlstm" in cfg.block_pattern else S


def _ref_generate(jcfg, p, toks, P):
    cache = j_init_cache(jcfg, B, P + GEN)
    logits, cache = jax.jit(lambda p, t, c: j_prefill(p, t, c, jcfg))(
        p, toks[:, :P], cache)
    out = [np.asarray(logits, np.float32)]
    step = jax.jit(lambda p, c, t, pos: j_decode(p, c, t, pos, jcfg))
    for s in range(GEN):
        logits, cache = step(p, cache, toks[:, P + s:P + s + 1],
                             jnp.int32(P + s))
        out.append(np.asarray(logits, np.float32))
    return out, cache


def _port_generate(model, toks, P):
    tt = torch.from_numpy(toks).long()
    cache = init_cache(model.cfg, B, P + GEN, CPU)
    logits, cache = prefill(model, tt[:, :P], cache)
    out = [_f32(logits)]
    for s in range(GEN):
        logits, cache = decode_step(model, cache, tt[:, P + s:P + s + 1],
                                    P + s)
        out.append(_f32(logits))
    return out, cache


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_decode_float32(arch):
    jcfg, p, tcfg, model = _case(arch, "float32")
    P = _prompt_len(jcfg)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, P + GEN)).astype(np.int32)
    want, jcache = _ref_generate(jcfg, p, toks, P)
    got, cache = _port_generate(model, toks, P)
    for g, w in zip(got, want):
        assert g.shape == (B, jcfg.vocab_size)
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    ref_layers = _ref_layers(jcache, jcfg)
    assert len(cache) == len(ref_layers) == tcfg.n_layers
    for i, (entry, ref) in enumerate(zip(cache, ref_layers)):
        assert type(entry) is type(ref) or isinstance(ref, tuple)
        for a, r in zip(_leaves(entry), _leaves(ref)):
            assert tuple(a.shape) == r.shape, i
            np.testing.assert_allclose(_f32(a), r.astype(np.float32),
                                       atol=1e-4, rtol=0, err_msg=str(i))


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_decode_bfloat16(arch):
    jcfg, p, _, model = _case(arch, "bfloat16")
    P = _prompt_len(jcfg)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, P + GEN)).astype(np.int32)
    want, _ = _ref_generate(jcfg, p, toks, P)
    got, _ = _port_generate(model, toks, P)
    truth, _ = _port_generate(_truth_model(arch), toks, P)
    for g, w, t in zip(got, want, truth):
        _bf16_class(g, w, t)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_causal_skip(dtype):
    """The triangular schedule equals the reference's, and equals the
    port's masked-full schedule exactly (the skipped blocks' combine
    factor is 0)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    jd = jnp.dtype(dtype)
    want = j_flash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                   q_pos=pos, k_pos=pos, causal=True, window=None, chunk=16,
                   causal_skip=True)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    qt, kt, vt = (torch.from_numpy(a).to(td) for a in (q, k, v))
    pt = torch.from_numpy(pos)
    got = flash_attention(qt, kt, vt, q_pos=pt, k_pos=pt, causal=True,
                          window=None, chunk=16, causal_skip=True)
    full = flash_attention(qt, kt, vt, q_pos=pt, k_pos=pt, causal=True,
                           window=None, chunk=16, causal_skip=False)
    assert torch.equal(got, full)
    tol = 1e-5 if dtype == "float32" else 0.02
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


def _full_forward_logits(model, toks):
    with torch.no_grad():
        h = forward(model, torch.from_numpy(toks).long())[0]
        return _f32(h[:, -1].float() @ model.head())


def test_ring_buffer_wrap_matches_reference_and_full_forward():
    """recurrentgemma's local attention at P = 24 > window 16: prefill
    writes each ring slot once (the last 16 positions), and prefill +
    decode equals the reference and a full forward over P + 1 tokens."""
    jcfg, p, tcfg, model = _case("recurrentgemma-2b", "float32")
    assert tcfg.window == 16 and S > tcfg.window
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    cache = init_cache(tcfg, B, S + 1, CPU)
    _, cache = prefill(model, torch.from_numpy(toks[:, :S]).long(), cache)
    ring = cache[2]
    assert ring["k"].shape[1] == 16
    assert sorted(ring["pos"].tolist()) == list(range(S - 16, S))
    assert (ring["pos"] % 16).tolist() == list(range(16))
    logits, cache = decode_step(model, cache,
                                torch.from_numpy(toks[:, S:]).long(), S)
    np.testing.assert_allclose(_f32(logits),
                               _full_forward_logits(model, toks),
                               atol=1e-4, rtol=0)
    jc = j_init_cache(jcfg, B, S + 1)
    _, jc = jax.jit(lambda p, t, c: j_prefill(p, t, c, jcfg))(
        p, toks[:, :S], jc)
    jl, _ = jax.jit(lambda p, c, t, pos: j_decode(p, c, t, pos, jcfg))(
        p, jc, toks[:, S:], jnp.int32(S))
    np.testing.assert_allclose(_f32(logits), np.asarray(jl), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("P", [16, 24])
def test_mlstm_padding_finding(P):
    """xLSTM at chunk 16: the port's prefill + decode equals a full
    forward over P + 1 tokens at P = 16 and at P = 24; the reference's
    does at P = 16 but not at P = 24, where its mLSTM state was decayed
    by 8 padding steps (0.5 each)."""
    jcfg, p, tcfg, model = _case("xlstm-1.3b", "float32")
    assert tcfg.attn_chunk == 16
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, P + 1)).astype(np.int32)
    full = _full_forward_logits(model, toks)
    cache = init_cache(tcfg, B, P + 1, CPU)
    _, cache = prefill(model, torch.from_numpy(toks[:, :P]).long(), cache)
    logits, _ = decode_step(model, cache,
                            torch.from_numpy(toks[:, P:]).long(), P)
    np.testing.assert_allclose(_f32(logits), full, atol=1e-4, rtol=0)

    jc = j_init_cache(jcfg, B, P + 1)
    _, jc = jax.jit(lambda p, t, c: j_prefill(p, t, c, jcfg))(
        p, toks[:, :P], jc)
    jl, _ = jax.jit(lambda p, c, t, pos: j_decode(p, c, t, pos, jcfg))(
        p, jc, toks[:, P:], jnp.int32(P))
    ref_err = np.abs(np.asarray(jl) - full).max()
    if P % tcfg.attn_chunk == 0:
        assert ref_err <= 1e-4
    else:
        assert ref_err > 0.5, ref_err


# ------------------------------------------------------------ init
def _port_leaf(model, cfg, path):
    """The port's tensor(s) for a reference leaf path, stacked over the
    groups for ``blocks/b{i}/...``."""
    if path[0] != "blocks" and path[0] != "rem":
        return getattr(model, path[0]).detach()
    n = len(cfg.block_pattern)
    b = int(path[1][1:])
    idx = ([g * n + b for g in range(cfg.n_groups)] if path[0] == "blocks"
           else [cfg.n_groups * n + b])
    ts = [getattr(getattr(model.layers[i], path[2]), path[3]).detach()
          for i in idx]
    return torch.stack(ts) if path[0] == "blocks" else ts[0]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-2b",
                                  "xlstm-1.3b", "granite-34b"])
def test_init_params_tree_and_scales(arch):
    """The port's init gives the reference's tree (shapes, dtypes) and
    per-leaf std within 10% (widths large enough that each leaf holds
    thousands of draws)."""
    jcfg, tcfg = _cfgs(arch)
    wide = dict(d_model=512, d_ff=256 if jcfg.d_ff else 0, vocab_size=512,
                rnn_width=jcfg.rnn_width and 512)
    if jcfg.n_experts:
        wide.update(d_ff=64)
    if "mlstm" in jcfg.block_pattern:
        wide.update(n_heads=8, n_kv_heads=8)
    jcfg, tcfg = jcfg.scaled(**wide), tcfg.scaled(**wide)
    shapes = jax.eval_shape(lambda k: j_init(k, jcfg), jax.random.PRNGKey(0))
    ref = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    model = init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert sum(int(np.prod(s.shape)) for _, s in flat) == sum(
        t.numel() for t in model.parameters())
    for path, leaf in flat:
        keys = tuple(k.key for k in path)
        got = _port_leaf(model, tcfg, keys)
        assert tuple(got.shape) == leaf.shape, keys
        assert str(got.dtype).split(".")[1] == str(leaf.dtype), keys
        r = np.asarray(_np_tree(ref)[keys[0]] if len(keys) == 1 else
                       functools.reduce(lambda t, k: t[k], keys, ref),
                       np.float32)
        g = _f32(got)
        if r.std() == 0:
            np.testing.assert_array_equal(g, r)
        else:
            assert abs(g.std() / r.std() - 1) < 0.10, keys
            assert abs(g.mean()) < 0.1 * r.std() + 1e-6, keys


def test_params_from_reference_checks_shapes():
    jcfg, p, tcfg, _ = _case("yi-9b", "float32")
    bad = _np_tree(p)
    bad["final_norm"] = bad["final_norm"][:-1]
    with pytest.raises(ValueError, match="does not fit"):
        params_from_reference(bad, tcfg, CPU)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = configs.get_smoke_config("yi-9b")
    for fn in (lambda: LM(cfg), lambda: init_cache(cfg, 1, 4),
               lambda: init_params(cfg, torch.Generator())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
