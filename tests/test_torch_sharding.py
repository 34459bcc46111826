"""The port's sharding rules and placements (``repro_torch.models.sharding``)
held against the JAX package's, exactly.

The reference runs once, in a subprocess over 512 forced host devices
(``--xla_force_host_platform_device_count=512``), nothing compiled: its
``make_rules`` on the (16, 16), (2, 16, 16), (2, 2) and (1, 4) meshes
with ``fsdp`` True and False; ``param_spec_tree`` over
``jax.eval_shape(init_params)`` for all ten archs; each arch's
per-device parameter bytes from ``NamedSharding.shard_shape`` on both
production meshes; ``cache_spec_tree`` for yi-9b, recurrentgemma-2b and
xlstm-1.3b at the decode_32k and long_500k batch sizes. Every port name
of every arch is compared (a stacked ``blocks/...`` leaf's spec without
its leading None), and the per-device bytes integer for integer.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import LM, init_cache, init_params
from repro_torch.models import sharding as shd
from repro_torch.models.model import ShardedLM, reference_key

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
CACHE_ARCHS = ("yi-9b", "recurrentgemma-2b", "xlstm-1.3b")

_REFERENCE = textwrap.dedent("""
    import json, math, sys
    import jax
    from jax.sharding import NamedSharding
    from repro import configs
    from repro.configs import SHAPES
    from repro.models import init_cache, init_params
    from repro.models.sharding import (cache_spec_tree, make_rules,
                                       param_spec_tree)
    meshes = json.loads(sys.argv[1])
    cache_archs = json.loads(sys.argv[2])
    assert jax.device_count() == 512
    enc = lambda s: [list(i) if isinstance(i, tuple) else i for i in s]
    path = lambda kp: "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in kp)
    jm = {n: jax.make_mesh(tuple(s), tuple(a)) for n, (s, a) in meshes.items()}
    out = {}
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        shapes = jax.eval_shape(lambda k: init_params(k, cfg),
                                jax.random.PRNGKey(0))
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        a = out[arch] = {"rules": {}, "params": {}, "bytes": {}, "cache": {}}
        for n, m in jm.items():
            for fsdp in (True, False):
                rules = make_rules(cfg, m, fsdp=fsdp)
                a["rules"][f"{n}/{fsdp}"] = {
                    k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in rules.items() if k != "_mesh"}
                if n in ("2x2", "1x4") and not fsdp:
                    continue
                specs = param_spec_tree(shapes, cfg, rules)
                sflat = jax.tree_util.tree_leaves(
                    specs, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))
                a["params"][f"{n}/{fsdp}"] = {
                    path(kp): enc(s) for (kp, _), s in zip(flat, sflat)}
                if fsdp and n in ("single", "multi"):
                    a["bytes"][n] = sum(
                        math.prod(NamedSharding(m, s).shard_shape(l.shape))
                        * l.dtype.itemsize for (_, l), s in zip(flat, sflat))
        if arch in cache_archs:
            for shape in ("decode_32k", "long_500k"):
                B, S = SHAPES[shape]["global_batch"], SHAPES[shape]["seq_len"]
                cache = jax.eval_shape(lambda: init_cache(cfg, B, S))
                cflat = jax.tree_util.tree_flatten_with_path(cache)[0]
                for n in ("single", "multi"):
                    specs = cache_spec_tree(cache, cfg, make_rules(cfg, jm[n]))
                    sflat = jax.tree_util.tree_leaves(
                        specs, is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))
                    a["cache"][f"{shape}/{n}"] = {
                        path(kp): enc(s) for (kp, _), s in zip(cflat, sflat)}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE,
         json.dumps({n: [list(s), list(a)] for n, (s, a) in MESHES.items()}),
         json.dumps(CACHE_ARCHS)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _mesh(name):
    shape, axes = MESHES[name]
    return shd.Mesh(shape, axes, "meta")


def _enc(spec):
    return [list(i) if isinstance(i, tuple) else i for i in spec]


def _ref_name(cfg, name):
    """The reference's path of a port parameter, and whether its leaf is
    stacked (a leading group axis)."""
    path, g = reference_key(cfg, name)
    return "/".join(path), g is not None


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_make_rules_match_reference(ref, arch):
    cfg = configs.get_config(arch)
    for key, want in ref[arch]["rules"].items():
        name, fsdp = key.split("/")
        mesh = _mesh(name)
        rules = shd.make_rules(cfg, mesh, fsdp=fsdp == "True")
        assert rules["_mesh"] is mesh
        got = {k: (list(v) if isinstance(v, tuple) else v)
               for k, v in rules.items() if k != "_mesh"}
        assert got == want, (arch, key)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_match_reference(ref, arch):
    """Every port name against the reference's spec of its leaf (the
    MLP's ``wo`` and the attention's ``wo_attn`` differ only by name)."""
    cfg = configs.get_config(arch)
    model = LM(cfg, "meta")
    names = [n for n, _ in model.named_parameters()]
    for key, want in ref[arch]["params"].items():
        name, fsdp = key.split("/")
        rules = shd.make_rules(cfg, _mesh(name), fsdp=fsdp == "True")
        got = shd.param_spec_tree(model, cfg, rules)
        assert list(got) == names
        seen = set()
        for n, spec in got.items():
            path, stacked = _ref_name(cfg, n)
            w = want[path]
            assert _enc(spec) == (w[1:] if stacked else w), (arch, key, n)
            assert len(spec) == model.get_parameter(n).ndim
            seen.add(path)
        assert seen == set(want), (arch, key, set(want) - seen)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_per_device_param_bytes_match_reference(ref, arch):
    """NamedSharding's shard_shape bytes, summed over the leaves, on both
    production meshes: the port's blocks give the same integer."""
    cfg = configs.get_config(arch)
    model = LM(cfg, "meta")
    for name, multi in (("single", False), ("multi", True)):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.devices[0].type == "meta" and mesh.size == (
            512 if multi else 256)
        specs = shd.param_spec_tree(model, cfg, shd.make_rules(cfg, mesh))
        got = sum(math.prod(shd.shard_shape(p.shape, specs[n], mesh))
                  * p.element_size() for n, p in model.named_parameters())
        assert got == ref[arch]["bytes"][name], (arch, name)


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_reference(ref, arch):
    """Ring caches of local attention stay unsharded on seq, recurrent
    states batch-sharded, and long_500k's batch of 1 replicated."""
    cfg = configs.get_config(arch)
    n_pat = len(cfg.block_pattern)
    for key, want in ref[arch]["cache"].items():
        shape, name = key.split("/")
        B, S = SHAPES[shape]["global_batch"], SHAPES[shape]["seq_len"]
        cache = init_cache(cfg, B, S, device="meta")
        specs = shd.cache_spec_tree(cache, cfg,
                                    shd.make_rules(cfg, _mesh(name)))
        n = 0
        for i, layer in enumerate(specs):
            g, b = divmod(i, n_pat)
            stacked = g < cfg.n_groups
            prefix = f"blocks/b{b}" if stacked else f"rem/r{b}"
            items = layer.items() if isinstance(layer, dict) \
                else enumerate(layer)
            for leaf, spec in items:
                w = want[f"{prefix}/{leaf}"]
                assert _enc(spec) == (w[1:] if stacked else w), (key, i, leaf)
                n += 1
        assert n >= len(want)


@pytest.mark.parametrize("arch,shape", [
    ("yi-9b", (2, 2)), ("olmoe-1b-7b", (4, 1)),
    ("recurrentgemma-2b", (1, 4)), ("xlstm-1.3b", (2, 2))])
def test_shard_params_full_gives_back_every_parameter(arch, shape):
    """On ["cpu"] * 4 every entry holds its own block (separate storage
    even on one device), and ``full`` gives back each parameter bit for
    bit."""
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    mesh = shd.Mesh(shape, ("data", "model"), ["cpu"] * 4)
    sharded = shd.shard_params(model, cfg, mesh)
    specs = shd.param_spec_tree(model, cfg, shd.make_rules(cfg, mesh))
    for n, p in model.named_parameters():
        s = sharded[n]
        assert s.spec == specs[n] and s.shape == p.shape
        assert torch.equal(s.full("cpu"), p.detach())
        ptrs = {b.data_ptr() for b in s.blocks}
        assert len(ptrs) == 4
        for e in range(4):
            assert s.blocks[e].shape == shd.shard_shape(p.shape, s.spec,
                                                        mesh)
    lm = ShardedLM(cfg, sharded)
    assert list(dict(lm.named_parameters())) == [
        n for n, _ in model.named_parameters()]


def test_a_spec_that_does_not_divide_raises():
    mesh = shd.Mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    with pytest.raises(ValueError, match="does not divide"):
        shd.Sharded.place(torch.zeros(6, 3), mesh, ("data", "model"))
    with pytest.raises(ValueError, match="twice"):
        shd.Sharded.place(torch.zeros(4, 4), mesh, ("data", "data"))
    with pytest.raises(ValueError, match="no axis"):
        shd.Sharded.place(torch.zeros(4, 4), mesh, ("pod", None))
    # granite-3-8b's vocab of 49,155: never split over "model"
    cfg = configs.get_config("granite-3-8b")
    rules = shd.make_rules(cfg, make_production_mesh())
    assert rules["vocab"] is None
    spec = shd.param_spec_tree({"embedding": torch.empty(
        cfg.vocab_size, cfg.d_model, device="meta")}, cfg, rules)
    assert spec["embedding"] == (None, "data")


def test_read_and_write_regions_with_replicas():
    """A region read from the blocks that cover it (the entry's own where
    it holds them), and a write that reaches every replica."""
    mesh = shd.Mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    x = torch.arange(64.0).reshape(8, 8)
    s = shd.Sharded.place(x, mesh, ("data", None))     # replicated on model
    assert s.boxes[0] == s.boxes[1] and s.distinct() == [0, 2]
    assert torch.equal(s.read(0), x)
    assert torch.equal(s.read(3, ((2, 6), (1, 3))), x[2:6, 1:3])
    s.write(torch.full((4, 8), -1.0), 0, ((4, 8), (0, 8)))
    for e in (2, 3):
        assert torch.equal(s.blocks[e], torch.full((4, 8), -1.0))
    assert torch.equal(s.blocks[0], x[:4])
    moved = []
    with shd.listen(lambda kind, n: moved.append((kind, n))):
        s.read(1, ((0, 8), (0, 8)))
    assert moved == [("all-gather", 4 * 8 * 4)]         # from entry 3
