"""Model assembly: the decoder/encoder covering all 10 archs.

The port of ``repro/models/model.py``: ``init_params``, ``init_cache``,
``forward``, ``prefill``, ``decode_step``, and the training half,
``chunked_ce``, ``loss_fn`` and ``train_step_fn``. The reference scans
over whole repeats of ``cfg.block_pattern`` with (G, ...) stacked
parameters and applies the pattern's remainder unrolled; the port holds
one module per layer in the same order — layer ``g·len(pattern) + i`` is
the reference's ``blocks/b{i}`` at group g, and the layers after the
``n_groups`` repeats are ``rem/r{i}``. :func:`reference_key` is that map;
:func:`params_from_reference` carries the reference's parameter tree
over by it, and :func:`reference_params` lists the parameters in the
order the reference flattens its tree.

Each layer is a :class:`Block` holding a mixer (:class:`Attention`,
:class:`RGLRU`, :class:`MLSTM` or :class:`SLSTM`) and an optional
:class:`MLP` or :class:`MoE`, registered under the reference's keys
(``layers.3.attn.wq``, ``layers.3.mlp.wi``), with the reference's
parameter names and (in, out) layouts, so ``h @ self.wq`` mirrors
``h @ p["wq"]``. The maths lives in the plain functions of ``layers.py``
and ``recurrent.py``.

The cache is a list with one entry per layer, with the reference's
leaves: dict(k, v, pos) for attention (updated in place), dict(conv, h)
for RG-LRU, (C, n, m) for mLSTM and (c, n, h, m) for sLSTM. Training
runs the full forward (no cache) under autograd; with ``cfg.remat`` each
layer is recomputed in the backward pass, as the reference remats each
pattern repeat.

Over a mesh (``rules`` from ``sharding.make_rules``), ``forward``,
``prefill``, ``decode_step``, ``loss_fn`` and ``train_step_fn`` run each
DP row's slice of the batch over the row's entries, tensor-parallel over
"model" (``sharding.py``'s docstring): the model is a :class:`ShardedLM`
(parameters as ``Sharded`` blocks), each entry gathers its box of one
layer at a time and computes its slice of each split sublayer
(:func:`_row_layer`); the residual lives on every entry. The cache's
leaves are ``Sharded`` by ``sharding.cache_spec_tree``. A dry run
computes one row (``rules["_rows"]``) on one entry (``Mesh.walk``),
which counts the others' moves to and from it. Without rules nothing
changes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..util import resolve_device
from . import sharding as shd
from .config import ModelConfig
from .layers import (attention_block, attention_entries, entry_heads,
                     gather_pieces, mlp_block, moe_block, moe_entries, norm)
from .recurrent import (mlstm_block, rglru_block, rglru_entries, slstm_block,
                        slstm_entries)

MOE_AUX_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)    # "bfloat16" | "float32"


# ------------------------------------------------------------ modules
class _Sublayer(nn.Module):
    """One sublayer's parameters under the reference's names. ``spec``
    maps name -> (shape, dtype, init): init is ("normal", std) or
    ("const", value), the reference's initializer for that leaf."""

    key = ""

    def __init__(self, spec: dict, device):
        super().__init__()
        self.spec = spec
        for name, (shape, dtype, _init) in spec.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))

    def tree(self) -> dict:
        """The parameters as the reference's dict of this sublayer."""
        return dict(self._parameters)


def _scales(cfg: ModelConfig):
    dt = torch_dtype(cfg)
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers * max(cfg.d_ff, cfg.d_model))
    return dt, out_scale


def _w(shape, dtype, std=None):
    """A normal leaf; the reference's default std is 1/sqrt(fan_in)."""
    return (tuple(shape), dtype,
            ("normal", std if std is not None else 1.0 / math.sqrt(shape[0])))


def _const(shape, dtype, value):
    return (tuple(shape), dtype, ("const", value))


class Attention(_Sublayer):
    """Global ('attn') or sliding-window ('local_attn') GQA attention."""

    key = "attn"

    def __init__(self, cfg: ModelConfig, kind: str, device):
        dt, out_scale = _scales(cfg)
        d, H, Kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        super().__init__({
            "norm": _const((d,), dt, 1.0),
            "wq": _w((d, H * hd), dt), "wk": _w((d, Kh * hd), dt),
            "wv": _w((d, Kh * hd), dt),
            "wo_attn": _w((H * hd, d), dt, out_scale)}, device)
        self.cfg = cfg
        self.window = cfg.window if kind == "local_attn" else None

    def forward(self, x, *, positions, cache=None):
        return attention_block(x, self.tree(), self.cfg,
                               positions=positions,
                               causal=not self.cfg.is_encoder,
                               window=self.window, cache=cache)


class RGLRU(_Sublayer):
    """Griffin's recurrent block."""

    key = "rglru"

    def __init__(self, cfg: ModelConfig, kind: str, device):
        dt, out_scale = _scales(cfg)
        d, dr, f32 = cfg.d_model, cfg.rnn_width or cfg.d_model, torch.float32
        super().__init__({
            "norm": _const((d,), dt, 1.0),
            "w_in": _w((d, dr), dt), "w_gate": _w((d, dr), dt),
            "conv_w": _w((cfg.conv_width, dr), dt, 0.1),
            "wa": _w((dr, dr), f32), "ba": _const((dr,), f32, 0.0),
            "wx": _w((dr, dr), f32), "bx": _const((dr,), f32, 0.0),
            "lam": _const((dr,), f32, 0.5),
            "w_out": _w((dr, d), dt, out_scale)}, device)
        self.cfg = cfg

    def forward(self, x, *, positions, cache=None):
        return rglru_block(x, self.tree(), self.cfg, state=cache)


class MLSTM(_Sublayer):
    """xLSTM's matrix-memory block."""

    key = "mlstm"

    def __init__(self, cfg: ModelConfig, kind: str, device):
        dt, out_scale = _scales(cfg)
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
        super().__init__({
            "norm": _const((d,), dt, 1.0),
            "wq": _w((d, H * hd), dt), "wk": _w((d, H * hd), dt),
            "wv": _w((d, H * hd), dt),
            "wi_gate": _w((d, H), dt), "wf_gate": _w((d, H), dt),
            "wo_gate": _w((d, H * hd), dt),
            "w_out": _w((H * hd, d), dt, out_scale)}, device)
        self.cfg = cfg

    def forward(self, x, *, positions, cache=None):
        return mlstm_block(x, self.tree(), self.cfg, state=cache)


class SLSTM(_Sublayer):
    """xLSTM's scalar-memory block."""

    key = "slstm"

    def __init__(self, cfg: ModelConfig, kind: str, device):
        dt, out_scale = _scales(cfg)
        d, H, hd, f32 = cfg.d_model, cfg.n_heads, cfg.hd, torch.float32
        r = 1.0 / math.sqrt(hd)
        super().__init__({
            "norm": _const((d,), dt, 1.0),
            **{w: _w((d, H * hd), dt) for w in ("wz", "wi", "wf", "wo_g")},
            **{w: _w((H, hd, hd), f32, r) for w in ("rz", "ri", "rf", "ro")},
            "w_out": _w((H * hd, d), dt, out_scale)}, device)
        self.cfg = cfg

    def forward(self, x, *, positions, cache=None):
        return slstm_block(x, self.tree(), self.cfg, state=cache)


class MLP(_Sublayer):
    key = "mlp"

    def __init__(self, cfg: ModelConfig, device):
        dt, out_scale = _scales(cfg)
        d, ff = cfg.d_model, cfg.d_ff
        spec = {"norm": _const((d,), dt, 1.0), "wi": _w((d, ff), dt),
                "wo": _w((ff, d), dt, out_scale)}
        if cfg.mlp_gated:
            spec["wg"] = _w((d, ff), dt)
        super().__init__(spec, device)
        self.cfg = cfg

    def forward(self, x):
        return mlp_block(x, self.tree(), self.cfg)


class MoE(_Sublayer):
    key = "moe"

    def __init__(self, cfg: ModelConfig, device):
        dt, out_scale = _scales(cfg)
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        spec = {"norm": _const((d,), dt, 1.0),
                "router": _w((d, E), torch.float32),
                "ewi": _w((E, d, ff), dt, 1.0 / math.sqrt(d)),
                "ewo": _w((E, ff, d), dt, out_scale)}
        if cfg.mlp_gated:
            spec["ewg"] = _w((E, d, ff), dt, 1.0 / math.sqrt(d))
        super().__init__(spec, device)
        self.cfg = cfg

    def forward(self, x):
        return moe_block(x, self.tree(), self.cfg)


MIXERS = {"attn": Attention, "local_attn": Attention, "rglru": RGLRU,
          "mlstm": MLSTM, "slstm": SLSTM}


class Block(nn.Module):
    """One layer: a mixer sublayer plus (optionally) an MLP or MoE one,
    each registered under the reference's key."""

    def __init__(self, kind: str, cfg: ModelConfig, device):
        super().__init__()
        if kind not in MIXERS:
            raise ValueError(kind)
        self.kind = kind
        mixer = MIXERS[kind](cfg, kind, device)
        self.mixer_key = mixer.key
        self.add_module(mixer.key, mixer)
        self.ffn_key = None
        if cfg.d_ff > 0:
            ffn = (MoE(cfg, device) if cfg.is_moe and mixer.key == "attn"
                   else MLP(cfg, device))
            self.ffn_key = ffn.key
            self.add_module(ffn.key, ffn)

    def sublayers(self):
        keys = (self.mixer_key,) + ((self.ffn_key,) if self.ffn_key else ())
        return [(k, getattr(self, k)) for k in keys]

    def forward(self, x, *, positions, cache=None):
        mix, new_c = getattr(self, self.mixer_key)(x, positions=positions,
                                                   cache=cache)
        x = x + mix
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.ffn_key == "moe":
            y, aux = self.moe(x)
            x = x + y
        elif self.ffn_key == "mlp":
            x = x + self.mlp(x)
        return x, new_c, aux


class LM(nn.Module):
    """The model: embedding (fp32), ``n_layers`` blocks in the reference's
    order, final norm, and the fp32 ``lm_head`` unless embeddings are tied.
    Parameters are allocated uninitialised; :func:`init_params` or
    :func:`params_from_reference` fills them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab_size
        self.embedding = nn.Parameter(
            torch.empty((V, d), dtype=torch.float32, device=dev))
        self.final_norm = nn.Parameter(
            torch.empty((d,), dtype=torch_dtype(cfg), device=dev))
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty((d, V), dtype=torch.float32, device=dev))
        self.layers = nn.ModuleList(
            Block(layer_kind(cfg, i), cfg, dev) for i in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def head(self) -> torch.Tensor:
        """The (d, V) fp32 output projection (the reference's
        ``_lm_head_matrix``)."""
        return self.embedding.T if self.lm_head is None else self.lm_head


def layer_kind(cfg: ModelConfig, i: int) -> str:
    """Layer i's block kind: the pattern cycles over the whole repeats, and
    the remainder is the pattern's first ``n_remainder`` blocks."""
    return cfg.block_pattern[i % len(cfg.block_pattern)]


# ------------------------------------------------------------ init
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """A model with the reference's distributions and scales: each weight
    normal × 1/sqrt(fan_in) (or its explicit scale: ``out_scale`` for the
    output projections, 0.1 for the conv, 1/sqrt(d) or 1/sqrt(hd) for the
    expert and recurrent matrices), the embedding normal × 0.02, norms 1,
    RG-LRU biases 0 and ``lam = 0.5``; embedding and ``lm_head`` in fp32.
    Draws come from ``generator`` on its own device (torch's numbers, not
    the reference's), and are moved to ``device``."""
    dev = resolve_device(device)
    model = LM(cfg, dev)
    gdev = generator.device

    def fill(param, init):
        kind, value = init
        with torch.no_grad():
            if kind == "const":
                param.fill_(value)
            else:
                param.copy_(torch.randn(param.shape, generator=generator,
                                        device=gdev) * value)

    fill(model.embedding, ("normal", 0.02))
    fill(model.final_norm, ("const", 1.0))
    if model.lm_head is not None:
        fill(model.lm_head, ("normal", 1.0 / math.sqrt(cfg.d_model)))
    for block in model.layers:
        for _key, sub in block.sublayers():
            for name, (_shape, _dt, init) in sub.spec.items():
                fill(getattr(sub, name), init)
    return model


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor (a tensor stays as it is); bfloat16
    arrays (numpy has no such dtype of its own) are carried by their
    bits."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    a = np.array(a)     # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def reference_key(cfg: ModelConfig, name: str):
    """Where the reference keeps the port's parameter ``name``: its path in
    the reference's tree, and the group index within that leaf's leading
    (G, ...) axis, or None for a leaf that is not stacked. Layer
    ``g·len(pattern) + i`` is ``blocks/b{i}`` at g for g < n_groups; the
    rest are ``rem/r{i}``."""
    parts = name.split(".")
    if parts[0] != "layers":
        return (name,), None
    g, b = divmod(int(parts[1]), len(cfg.block_pattern))
    if g < cfg.n_groups:
        return ("blocks", f"b{b}", *parts[2:]), g
    return ("rem", f"r{b}", *parts[2:]), None


def reference_leaf(tree, cfg: ModelConfig, name: str):
    """The reference tree's value for the port's parameter ``name``."""
    path, g = reference_key(cfg, name)
    for k in path:
        tree = tree[k]
    return tree if g is None else tree[g]


def reference_params(model: LM) -> dict:
    """The model's parameters by name, in the order the reference
    flattens its tree (sorted keys, a stacked leaf's groups together), so
    that sums over them add in the reference's order."""
    params = dict(model.named_parameters())

    def order(name):
        path, g = reference_key(model.cfg, name)
        return path, -1 if g is None else g
    return {n: params[n] for n in sorted(params, key=order)}


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """The JAX package's parameter tree (numpy leaves) as the port's
    :class:`LM`, by :func:`reference_key`'s map. Every leaf must match the
    port's shape and dtype."""
    model = LM(cfg, resolve_device(device))
    with torch.no_grad():
        for name, param in model.named_parameters():
            _put(param, reference_leaf(tree, cfg, name))
    return model


def _put(dst: torch.Tensor, a) -> None:
    t = _tensor(a)
    if t.shape != dst.shape or t.dtype != dst.dtype:
        raise ValueError(f"leaf {tuple(t.shape)} {t.dtype} does not fit "
                         f"{tuple(dst.shape)} {dst.dtype}")
    dst.copy_(t)


# ------------------------------------------------------------ cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None, rules=None) -> list:
    """Decode cache, one entry per layer with the reference's leaves:
    attention dict(k, v (B, Smax, Kh, hd) in the model dtype, pos (Smax,)
    int32 = -1) with Smax = min(window or max_len, max_len); RG-LRU
    dict(conv (B, W-1, Dr), h (B, Dr)) fp32; mLSTM (C, n, m) and sLSTM
    (c, n, h, m) fp32 with m = -1e30. With ``rules`` over a mesh, every
    leaf is ``Sharded`` by ``sharding.cache_spec_tree`` (``device`` is
    then unused)."""
    mesh = (rules or {}).get("_mesh")
    dev = None if mesh is not None else resolve_device(device)
    Kh, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    dt, f32 = torch_dtype(cfg), torch.float32

    def leaf(shape, fill=0.0, dtype=f32):
        return (tuple(shape), dtype, fill)

    def block_cache(kind: str):
        if kind in ("attn", "local_attn"):
            Smax = cfg.window if (kind == "local_attn" and cfg.window) \
                else max_len
            Smax = min(Smax, max_len)
            return {"k": leaf((batch, Smax, Kh, hd), dtype=dt),
                    "v": leaf((batch, Smax, Kh, hd), dtype=dt),
                    "pos": leaf((Smax,), -1, torch.int32)}
        if kind == "rglru":
            dr = cfg.rnn_width or cfg.d_model
            return {"conv": leaf((batch, cfg.conv_width - 1, dr)),
                    "h": leaf((batch, dr))}
        if kind == "mlstm":
            return (leaf((batch, H, hd, hd)), leaf((batch, H, hd)),
                    leaf((batch, H), -1e30))
        if kind == "slstm":
            z = leaf((batch, H, hd))
            return (z, z, z, leaf((batch, H, hd), -1e30))
        raise ValueError(kind)

    leaves = [block_cache(layer_kind(cfg, i)) for i in range(cfg.n_layers)]
    if mesh is None:
        def make(c):
            shape, dtype, fill = c
            return torch.full(shape, fill, dtype=dtype, device=dev)
        return _map_cache(make, leaves)
    specs = shd.cache_spec_tree(_map_cache(
        lambda c: torch.empty(c[0], dtype=c[1], device="meta"), leaves),
        cfg, rules)
    return [_map_cache(lambda c, s: shd.Sharded.empty(
        c[0], c[1], mesh, s, fill=c[2]), lc, ls)
        for lc, ls in zip(leaves, specs)]


def _map_cache(fn, cache, *more):
    """``fn`` over a cache's leaves (a list of dicts / tuples per layer,
    or one layer's dict / tuple), keeping its structure."""
    if isinstance(cache, list):
        return [_map_cache(fn, c, *(m[i] for m in more))
                for i, c in enumerate(cache)]
    if isinstance(cache, dict):
        return {k: fn(v, *(m[k] for m in more)) for k, v in cache.items()}
    return type(cache)(fn(v, *(m[i] for m in more))
                       for i, v in enumerate(cache))


# ------------------------------------------------------------ meshes
class ShardedLM:
    """An LM whose parameters live as ``Sharded`` blocks on a mesh: a
    skeleton ``LM`` on "meta" (its modules run through
    ``functional_call``) and the blocks by parameter name, in the
    model's order. ``rules`` (default ``make_rules(cfg, mesh)``) are the
    ones the blocks were placed by."""

    def __init__(self, cfg: ModelConfig, params: dict, rules=None):
        self.cfg = cfg
        self.skeleton = LM(cfg, "meta")
        self.params = {n: params[n]
                       for n, _ in self.skeleton.named_parameters()}
        mesh = next(iter(self.params.values())).mesh
        self.rules = rules if rules is not None else shd.make_rules(cfg,
                                                                    mesh)

    @classmethod
    def place(cls, model: LM, mesh, rules=None) -> "ShardedLM":
        """``model``'s parameters cut into blocks on ``mesh``."""
        rules = rules if rules is not None else shd.make_rules(model.cfg,
                                                               mesh)
        return cls(model.cfg, shd.shard_params(model, model.cfg, mesh,
                                               rules), rules)

    @property
    def mesh(self):
        return self.rules["_mesh"]

    def named_parameters(self):
        return iter(self.params.items())


class _Gather(torch.autograd.Function):
    """An entry's ``region`` of a parameter (default the whole of it),
    gathered from the blocks onto the entry; backward adds the entry's
    gradient of the region into every target entry's fp32 buffer block
    that overlaps it (a reduce-scatter over the rows and the entries
    that share the region, an all-reduce for a replicated buffer; inside
    ``Mesh.walk``, counted only towards an entry that does not compute).
    ``anchor`` is a 0-d tensor that requires grad, so the gathered
    tensor is part of the graph."""

    @staticmethod
    def forward(ctx, anchor, sharded, entry, region, prefer, buf):
        ctx.entry, ctx.buf = entry, buf
        ctx.region = region if region is not None else tuple(
            (0, n) for n in sharded.shape)
        return sharded.read(entry, region, prefer=prefer)

    @staticmethod
    def backward(ctx, g):
        buf, e, region = ctx.buf, ctx.entry, ctx.region
        kind = ("reduce-scatter" if any(buf.spec) else "all-reduce")
        origin = [lo for lo, _ in region]
        for b, box in enumerate(buf.boxes):
            ov = shd._overlap(box, region)
            if ov is None:
                continue
            piece = buf.mesh.move(g[shd._index(ov, origin)], e, b, kind)
            if buf.mesh.computes(b):
                buf.blocks[b][shd._index(ov, [lo for lo, _ in box])].add_(
                    piece)
        return None, None, None, None, None, None


def _row_params(model, row, grads: dict | None):
    """A getter ``get(name, entry, region=None, whole=False)`` of a
    parameter on an entry of ``row``: its tensor-parallel box
    (``sharding.model_box``) by default, the whole of it with
    ``whole``, or ``region``. With ``grads`` (fp32 ``Sharded`` buffers
    by name) the gathered tensors' gradients go there."""
    anchors = {}

    def get(name, entry, region=None, whole=False):
        sh = model.params[name]
        if region is None and not whole:
            region = shd.model_box(sh.shape, sh.spec, sh.mesh, entry)
        if grads is None:
            return sh.read(entry, region, prefer=row.entries)
        if entry not in anchors:
            anchors[entry] = torch.zeros((), device=sh.mesh.devices[entry],
                                         requires_grad=True)
        return _Gather.apply(anchors[entry], sh, entry, region, row.entries,
                             grads[name])
    return get


def _take(x, lo: int, n: int, row, kind="all-to-all"):
    """Rows [lo, lo + n) of a batch leaf on ``row``'s device: a slice of a
    plain tensor, or the region of a ``Sharded`` one (held by the row
    when the batch was placed by ``batch_sharding``)."""
    if isinstance(x, shd.Sharded):
        region = ((lo, lo + n),) + tuple((0, d) for d in x.shape[1:])
        return x.read(row.home, region, kind=kind, prefer=row.entries)
    return x[lo:lo + n].to(row.device)


def _mesh_rows(model, rules, B: int, cache=None):
    """The DP rows a mesh call computes: ``rules["_rows"]`` when given (a
    dry run's one row), else every row of the mesh for batch B — only
    the first when the batch is replicated over the rows (B does not
    divide them) and no cache replica needs each row's update."""
    if rules.get("_rows") is not None:
        return list(rules["_rows"])
    rows = rules["_mesh"].rows(shd._names(rules["batch"]), B)
    if cache is None and _replicated(rows, B):
        return rows[:1]
    return rows


def _replicated(rows, B: int) -> bool:
    """Whether each of several rows holds the whole batch."""
    return len(rows) > 1 and rows[0].size == B


def _all_reduce(mesh, row, parts: dict) -> dict:
    """``parts`` (computing entry -> its partial, on it) summed onto each
    of them as a ring does: entry j adds the j-th of m slices of the last
    dim of every partial, in entry order (a reduce-scatter), then gathers
    the others' sums (an all-gather); every element adds in entry order,
    so every entry gets the same bits."""
    ents = row.entries
    m = len(ents)
    if m == 1:
        return parts
    kind = "all-reduce"
    cut = mesh.all_gather(parts, ents, kind, lambda t, d: torch.tensor_split(
        t, m, dim=-1)[ents.index(d)])
    sums = {}
    for e, pieces in cut.items():
        acc = pieces[0]
        for p in pieces[1:]:
            acc = acc + p
        sums[e] = acc
    return {e: torch.cat(got, dim=-1)
            for e, got in mesh.all_gather(sums, ents, kind).items()}


def _vocab_split(rules, row) -> bool:
    """Whether the embedding rows and the head's columns split over the
    row's entries (the "vocab" rule; granite-3-8b's odd vocab does not)."""
    return rules.get("vocab") == "model" and len(row.entries) > 1


def _shares(cfg, row, sub):
    """Each entry of ``row``'s share of sublayer ``sub``: attention's
    heads (``layers.entry_heads``), the RG-LRU's channels, the mLSTM's
    and sLSTM's heads or a head's value columns
    (``sharding.head_shares``); None for the MLP and MoE, whose
    tensor-parallel boxes (``sharding.model_box``) are their shares."""
    m = len(row.entries)
    if isinstance(sub, Attention):
        return entry_heads(cfg, row)
    if isinstance(sub, RGLRU):
        units = shd.split_units(cfg.rnn_width or cfg.d_model, m)
    elif isinstance(sub, (MLSTM, SLSTM)):
        units = shd.head_shares(cfg.n_heads, cfg.hd, m)
    else:
        return None
    return dict(zip(row.entries, units))


def _cut(shape, **dims):
    """A region of a leaf of ``shape``: (lo, hi) on the dims named
    ``d0``, ``d1``, ..., the whole of every other."""
    return tuple(dims.get(f"d{i}", (0, n)) for i, n in enumerate(shape))


def _regions(sub, share, cfg) -> dict:
    """The region of each of ``sub``'s leaves that an entry with
    ``share`` reads (a leaf not named: its "model" box; the norm's is
    whole). The rules keep some of these leaves whole over "model"
    (attention's under undivided heads, ``wa``/``wx``, the recurrent
    matrices, ``w_out``): the entry reads its region of them."""
    hd = cfg.hd
    if isinstance(sub, Attention):
        q, kv = (share[0] * hd, share[1] * hd), share[4:]
        return {"wq": dict(d1=q), "wo_attn": dict(d0=q), "wk": dict(d1=kv),
                "wv": dict(d1=kv)}
    if isinstance(sub, RGLRU):
        ch = dict(d1=share)
        return {"w_in": ch, "w_gate": ch, "conv_w": ch, "wa": ch, "wx": ch,
                "ba": dict(d0=share), "bx": dict(d0=share),
                "lam": dict(d0=share), "w_out": dict(d0=share)}
    a, b, c0, c1 = share
    heads = dict(d1=(a * hd, b * hd))
    vc = (a * hd + c0, (b - 1) * hd + c1)        # its value columns
    if isinstance(sub, MLSTM):
        return {"wq": heads, "wk": heads, "wi_gate": dict(d1=(a, b)),
                "wf_gate": dict(d1=(a, b)), "wv": dict(d1=vc),
                "wo_gate": dict(d1=vc), "w_out": dict(d0=vc)}
    return {**{w: dict(d1=vc) for w in ("wz", "wi", "wf", "wo_g")},
            **{w: dict(d0=(a, b), d2=(c0, c1))
               for w in ("rz", "ri", "rf", "ro")},
            "w_out": dict(d0=vc)}


def _sub_params(get, prefix, sub, e, shares, cfg):
    """The sublayer's parameters on entry ``e``: its region of each
    (:func:`_regions`) or its tensor-parallel box."""
    regions = {} if shares is None else _regions(sub, shares[e], cfg)
    return {n: get(prefix + n, e, region=_cut(shape, **regions[n])
                   if n in regions else None)
            for n, (shape, _dt, _init) in sub.spec.items()}


def _state_regions(kind, cfg, row, share):
    """The region of each leaf of a recurrent mixer's state (``kind``'s
    cache entry) that an entry with ``share`` updates, in the row's
    batch rows."""
    rows = (row.start, row.start + row.size)
    if kind == "rglru":
        return {"conv": (rows, (0, cfg.conv_width - 1), share),
                "h": (rows, share)}
    a, b, c0, c1 = share
    if kind == "mlstm":
        return ((rows, (a, b), (0, cfg.hd), (c0, c1)),
                (rows, (a, b), (0, cfg.hd)), (rows, (a, b)))
    return ((rows, (a, b), (c0, c1)),) * 4


def _embed(model, row, x_in, rules, get) -> dict:
    """The row's input embeddings on each computing entry: with the vocab
    split, each entry looks up the tokens in its rows (zeros elsewhere)
    and the partials are all-reduced (one term a token: exact); else the
    home's lookup, all-gathered."""
    cfg = model.cfg
    dt = torch_dtype(cfg)
    mesh = rules["_mesh"]
    if x_in.ndim == 3:
        return mesh.spread(x_in.to(dt), row.home, row.entries, "all-gather")
    if not _vocab_split(rules, row):
        return mesh.spread(get("embedding", row.home, whole=True)[x_in].to(
            dt), row.home, row.entries, "all-gather")
    toks = mesh.spread(x_in, row.home, row.entries, "all-gather")
    parts = {}
    for e in toks:
        emb = get("embedding", e)
        n = emb.shape[0]
        t = toks[e] - row.entries.index(e) * n
        mine = (t >= 0) & (t < n)
        parts[e] = torch.where(mine[..., None], emb[t.clamp(0, n - 1)], 0.0)
    return {e: v.to(dt) for e, v in _all_reduce(mesh, row, parts).items()}


def _row_layer(model, layer, prefix, row, xs, positions, c, rules, get,
               st):
    """One layer of a row: ``xs`` the residual on each computing entry;
    each sublayer split over the row's entries (:func:`_shares`; an
    entry without attention heads adds nothing), the partials
    all-reduced into every entry's residual. ``c``: attention's cache
    entry, or each computing entry's block of the recurrent state.
    Returns (xs, each entry's block of the mixer's new state or None)."""
    cfg = model.cfg
    mesh = rules["_mesh"]
    nc = None
    for key, sub in layer.sublayers():
        shares = _shares(cfg, row, sub)
        on = {e: x for e, x in xs.items() if not isinstance(sub, Attention)
              or shares[e][1] > shares[e][0]}
        ps = {e: _sub_params(get, prefix + key + ".", sub, e, shares, cfg)
              for e in on}
        if isinstance(sub, Attention):
            # (a walk of an entry without heads skips it: it adds zeros)
            parts = on and attention_entries(on, ps, cfg, rules, row=row,
                                      positions=positions,
                                      causal=not cfg.is_encoder,
                                      window=sub.window, cache=c)
        elif isinstance(sub, MLP):
            parts = {e: mlp_block(x, ps[e], cfg) for e, x in on.items()}
        elif isinstance(sub, MoE):
            parts = moe_entries(on, ps, cfg, mesh, row, st)
        elif isinstance(sub, RGLRU):
            parts, nc = rglru_entries(on, ps, cfg, mesh, row, shares, c)
        elif isinstance(sub, MLSTM):
            out = {e: mlstm_block(x, ps[e], cfg, state=None if c is None
                                  else c[e]) for e, x in on.items()}
            parts = {e: y for e, (y, _) in out.items()}
            nc = None if c is None else {e: s for e, (_, s) in out.items()}
        else:
            parts, nc = slstm_entries(on, ps, cfg, mesh, row, shares, c)
        ys = _all_reduce(mesh, row, {e: parts[e] if e in parts
                                     else torch.zeros_like(x)
                                     for e, x in xs.items()})
        xs = {e: xs[e] + ys[e] for e in xs}
    return xs, nc


def _row_hidden(model, row, x_in, positions, cache, rules, get):
    """One DP row through the model: (hidden (B_r, S, d) on each
    computing entry, per layer the MoE (me, ce) of the row or ())."""
    cfg = model.cfg
    rules_r = {**rules, "_rows": (row,)}
    xs = _embed(model, row, x_in, rules_r, get)
    ents = tuple(xs)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    stats = []
    for i, layer in enumerate(model.skeleton.layers):
        prefix = f"layers.{i}."
        c = None if cache is None else cache[i]
        states = None
        if c is not None and layer.kind not in ("attn", "local_attn"):
            # recurrent states: each entry's block of the row's, from its
            # own replica (over "model" every entry holds the whole)
            shares = _shares(cfg, row, getattr(layer, layer.mixer_key))
            regions = {e: _state_regions(layer.kind, cfg, row, shares[e])
                       for e in ents}
            states = {e: _map_cache(lambda t, r, e=e: t.read(
                e, r, prefer=row.entries), c, regions[e]) for e in ents}

        def run(*x, layer=layer, prefix=prefix,
                c=c if states is None else states):
            st = []
            ys, nc = _row_layer(model, layer, prefix, row, dict(zip(ents, x)),
                                positions, c, rules_r, get, st)
            return (*ys.values(), nc, *[t for pair in st for t in pair])

        if remat:
            out = checkpoint(run, *xs.values(), use_reentrant=False)
        else:
            out = run(*xs.values())
        n = len(ents)
        xs, nc, st = dict(zip(ents, out[:n])), out[n], out[n + 1:]
        if states is not None:
            _write_states(c, nc, regions, row)
        stats.append(tuple(st))
    fn = {e: get("final_norm", e, whole=True) for e in ents}
    return {e: norm(x, fn[e], cfg.norm_type) for e, x in xs.items()}, stats


def _write_states(c, new, regions, row):
    """Each entry's block of a recurrent state (``new``: entry -> its
    leaves, at ``regions``) written into every replica the row holds;
    a block two entries share (a head's n and m, which the entries
    sharing the head compute alike) once, by the first."""
    done = set()

    def write(sh, t, r, e):
        if (id(sh), r) not in done:
            done.add((id(sh), r))
            sh.write(t, e, r, entries=row.entries)
    for e, leaves in new.items():
        _map_cache(lambda sh, t, r, e=e: write(sh, t, r, e), c, leaves,
                   regions[e])


def _mesh_aux(row_stats, device, mesh, rows):
    """The global batch's MoE aux loss from the rows' (me, ce): per MoE
    layer, the means over all the rows' groups, as the unsharded
    ``moe_block`` takes them over its groups."""
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for layer in zip(*row_stats):
        if not layer[0]:
            continue
        me = ce = None
        G = 0
        for (me_r, ce_r), row in zip(layer, rows):
            a = mesh.move(me_r.sum(0), row.home, rows[0].home, "all-reduce")
            b = mesh.move(ce_r.sum(0), row.home, rows[0].home, "all-reduce")
            me = a if me is None else me + a
            ce = b if ce is None else ce + b
            G += me_r.shape[0]
        aux = aux + ((me / G) * (ce / G)).sum()
    return aux


def _head(model, get, entry, whole=False):
    """The (d, V) fp32 output projection on ``entry``: its vocab columns
    (``embedding.T`` when tied), or the whole of it."""
    if model.cfg.tie_embeddings:
        return get("embedding", entry, whole=whole).T
    return get("lm_head", entry, whole=whole)


def _mesh_forward(model, inputs, rules, positions, cache, grads=None,
                  offset=0, B=None):
    """Each row's (row, hidden on each computing entry, MoE stats,
    getter) for rows [offset, offset + B) of ``inputs`` (all of them by
    default)."""
    if not isinstance(model, ShardedLM):
        raise ValueError("a mesh call needs a ShardedLM (ShardedLM.place)")
    B = inputs.shape[0] if B is None else B
    out = []
    for row in _mesh_rows(model, rules, B, cache):
        x_in = _take(inputs, offset + row.start, row.size, row)
        get = _row_params(model, row, grads)
        hs, st = _row_hidden(model, row, x_in, positions.to(row.device),
                             cache, rules, get)
        out.append((row, hs, st, get))
    if _replicated([r for r, *_ in out], B):
        return out[:1]      # every row computed the same batch
    return out


def _mesh_gather_rows(mesh, rows, ts):
    """The rows' tensors concatenated on the first row's device."""
    if len(ts) == 1:
        return ts[0]
    return torch.cat([mesh.move(t, r.home, rows[0].home, "all-gather")
                      for t, r in zip(ts, rows)])


# ------------------------------------------------------------ forward
def forward(model, inputs, rules=None, *, positions=None, cache=None):
    """Returns (hidden (B,S,d), new_cache, aux_loss).

    inputs: int tokens (B, S) or float embeddings (B, S, d) (stub
    frontends). cache: from :func:`init_cache` (positions required), or
    None. Without a cache and with grad enabled, ``cfg.remat`` wraps each
    layer in a non-reentrant activation checkpoint. With ``rules`` over a
    mesh, each DP row runs its slice (see the module docstring); the
    hidden states come back on the first row's entry.
    """
    cfg = model.cfg
    if (rules or {}).get("_mesh") is not None:
        S = inputs.shape[1]
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=rules["_mesh"].devices[0])
        res = _mesh_forward(model, inputs, rules, positions, cache)
        rows = [r for r, *_ in res]
        mesh = rules["_mesh"]
        # a walk of another entry than the home returns that entry's
        hidden = _mesh_gather_rows(mesh, rows, [
            r[1][r[0].home] if r[0].home in r[1] else next(iter(
                r[1].values())) for r in res])
        aux = _mesh_aux([r[2] for r in res], hidden.device, mesh, rows)
        return hidden, cache, aux
    dt = torch_dtype(cfg)
    if inputs.ndim == 2:
        # gather, then cast: the reference casts the whole table first,
        # which gives the same rows
        x = model.embedding[inputs].to(dt)
    else:
        x = inputs.to(dt)
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = None if cache is None else []
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i, layer in enumerate(model.layers):
        if remat:
            x, nc, aux = checkpoint(layer, x, positions=positions,
                                    use_reentrant=False)
        else:
            x, nc, aux = layer(x, positions=positions,
                               cache=None if cache is None else cache[i])
        aux_total = aux_total + aux
        if cache is not None:
            new_cache.append(nc)
    return norm(x, model.final_norm, cfg.norm_type), new_cache, aux_total


def _logits(model, rules, tokens, positions, cache):
    """The last position's fp32 logits (B, V): each row's on its home
    over a mesh (with the vocab split, each entry's columns all-gathered
    there), gathered on the first row's."""
    if (rules or {}).get("_mesh") is None:
        hidden, new_cache, _ = forward(model, tokens, positions=positions,
                                       cache=cache)
        return hidden[:, -1].float() @ model.head(), new_cache
    mesh = rules["_mesh"]
    res = _mesh_forward(model, tokens, rules, positions, cache)
    logits = []
    for row, hs, _, get in res:
        if not _vocab_split(rules, row):
            logits.append(hs[row.home][:, -1].float()
                          @ _head(model, get, row.home, whole=True))
            continue
        parts = {e: h[:, -1].float() @ _head(model, get, e)
                 for e, h in hs.items()}
        logits.append(gather_pieces(mesh, parts, row.entries, row.home, -1))
    return _mesh_gather_rows(mesh, [r[0] for r in res], logits), cache


# ------------------------------------------------------------ decode
@torch.no_grad()
def decode_step(model, cache: list, tokens, pos, rules=None):
    """One decode step: tokens (B, 1) int, pos the absolute position (an
    int or a 0-d tensor). Returns (logits (B, V) fp32, new_cache)."""
    dev = tokens.device if not isinstance(tokens, shd.Sharded) \
        else tokens.mesh.devices[0]
    positions = torch.arange(1, dtype=torch.int32, device=dev) + pos
    return _logits(model, rules, tokens, positions, cache)


@torch.no_grad()
def prefill(model, tokens, cache: list, rules=None):
    """Prefill the cache with a prompt (B, S); returns (last_logits, cache)."""
    dev = tokens.device if not isinstance(tokens, shd.Sharded) \
        else tokens.mesh.devices[0]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=dev)
    return _logits(model, rules, tokens, positions, cache)


# ------------------------------------------------------------ loss
def _ce_sums(hidden, W, targets, cfg: ModelConfig):
    """The chunked CE's sums: (Σ (lse - label logit), Σ lse², valid token
    count) over the valid targets, a ``ce_chunk`` at a time."""
    h, t, ck, nc = _chunks(hidden, targets, cfg)
    Wf = W.float()
    dev = hidden.device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    zloss = torch.zeros((), dtype=torch.float32, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    for c in range(nc):
        hc, tc = h[:, c * ck:(c + 1) * ck], t[:, c * ck:(c + 1) * ck]
        logits = hc.float() @ Wf                              # (B, ck, V)
        lse = torch.logsumexp(logits, dim=-1)
        lab = logits.gather(-1, tc.clamp_min(0).long()[..., None])[..., 0]
        valid = tc >= 0
        loss = loss + torch.where(valid, lse - lab, 0.0).sum()
        zloss = zloss + torch.where(valid, lse.square(), 0.0).sum()
        count = count + valid.sum(dtype=torch.int32)
    return loss, zloss, count


def _ce_mean(loss, zloss, count):
    n = count.clamp_min(1)
    return loss / n + Z_LOSS_WEIGHT * zloss / n


def _chunks(hidden, targets, cfg):
    """hidden and targets padded to whole ``ce_chunk``s (targets with -1),
    the chunk length and count."""
    S = hidden.shape[1]
    ck = min(cfg.ce_chunk, S)
    nc = -(-S // ck)
    return (F.pad(hidden, (0, 0, 0, nc * ck - S)),
            F.pad(targets, (0, nc * ck - S), value=-1), ck, nc)


def _ce_sums_split(model, row, hs, targets, rules, get):
    """:func:`_ce_sums` with the head's vocab columns split over the
    row's entries: per chunk each entry takes its logits' max m_j and
    s_j = Σ exp(l - m_j) and the label logit where its columns hold the
    target (else 0); on the home, m = max_j m_j, lse = m + log Σ_j s_j ·
    exp(m_j - m), the label logit the sum over the entries. The maxes
    are constants of the gradient (they cancel in lse's)."""
    cfg = model.cfg
    mesh = rules["_mesh"]
    home = row.home
    ents = tuple(hs)
    hp = {e: _chunks(h, targets, cfg)[0] for e, h in hs.items()}
    _, tp, ck, nc = _chunks(hs[home], targets, cfg)
    ts = mesh.spread(tp, home, row.entries, "all-gather")
    Ws = {e: _head(model, get, e).float() for e in ents}
    zero = dict(device=tp.device)
    loss = torch.zeros((), dtype=torch.float32, **zero)
    zloss = torch.zeros((), dtype=torch.float32, **zero)
    count = torch.zeros((), dtype=torch.int32, **zero)
    for c in range(nc):
        sl = slice(c * ck, (c + 1) * ck)
        stat = {"m": {}, "s": {}, "lab": {}}
        for e in ents:
            W = Ws[e]
            n = W.shape[1]
            logits = hp[e][:, sl].float() @ W                 # (B, ck, V_j)
            m = logits.detach().amax(dim=-1)
            t = ts[e][:, sl] - row.entries.index(e) * n
            mine = (t >= 0) & (t < n)
            lab = logits.gather(-1, t.clamp(0, n - 1).long()[..., None])
            stat["m"][e] = m
            stat["s"][e] = torch.exp(logits - m[..., None]).sum(-1)
            stat["lab"][e] = torch.where(mine, lab[..., 0], 0.0)
        ms, ss, labs = (mesh.gather(stat[k], row.entries, home, "all-reduce")
                        for k in ("m", "s", "lab"))
        mx = ms[0]
        for m in ms[1:]:
            mx = torch.maximum(mx, m)
        tot = lab = None
        for m, s_, lb in zip(ms, ss, labs):
            term = s_ * torch.exp(m - mx)
            tot = term if tot is None else tot + term
            lab = lb if lab is None else lab + lb
        lse = mx + torch.log(tot)
        tc = tp[:, sl]
        valid = tc >= 0
        loss = loss + torch.where(valid, lse - lab, 0.0).sum()
        zloss = zloss + torch.where(valid, lse.square(), 0.0).sum()
        count = count + valid.sum(dtype=torch.int32)
    return loss, zloss, count


def chunked_ce(hidden, W, targets, cfg: ModelConfig):
    """Cross-entropy over sequence chunks of ``cfg.ce_chunk``, so the
    (B, S, V) logits never exist at once in the forward pass.

    hidden (B, S, d) in the model dtype; W (d, V) fp32; targets (B, S)
    int (-1 = ignore; the tail of the last chunk is padded with -1).
    Logits are fp32; the loss adds the z-loss ``Z_LOSS_WEIGHT · Σ lse² /
    n`` with n = max(count, 1). The chunks add in order, as the
    reference's scan does. Returns (mean loss fp32, token count int32).
    """
    loss, zloss, count = _ce_sums(hidden, W, targets, cfg)
    return _ce_mean(loss, zloss, count), count


def _mesh_loss(model, batch, rules, grads=None, offset=0, B=None):
    """The loss of rows [offset, offset + B) of a global batch over a
    mesh: each row's CE sums and MoE statistics, all-reduced on the first
    row's entry into the unsharded loss of those rows."""
    mesh = rules["_mesh"]
    S = batch["targets"].shape[1]
    res = _mesh_forward(model, batch["inputs"], rules, torch.arange(
        S, dtype=torch.int32, device=mesh.devices[0]), None, grads, offset,
        B)
    rows = [r for r, *_ in res]
    home = rows[0].home
    sums = None
    for row, hs, _, get in res:
        t = _take(batch["targets"], offset + row.start, row.size, row)
        if _vocab_split(rules, row):
            row_sums = _ce_sums_split(model, row, hs, t, rules, get)
        else:
            row_sums = _ce_sums(hs[row.home], _head(model, get, row.home,
                                                    whole=True), t, model.cfg)
        part = [mesh.move(v, row.home, home, "all-reduce") for v in row_sums]
        sums = part if sums is None else [a + b for a, b in zip(sums, part)]
    ce = _ce_mean(*sums)
    aux = _mesh_aux([r[2] for r in res], ce.device, mesh, rows)
    loss = ce + MOE_AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux, "tokens": sums[2]}


def loss_fn(model, batch: dict, rules=None):
    """batch: dict(inputs (B, S) int or (B, S, d) float, targets (B, S)
    int). Returns (loss, metrics dict(ce, aux, tokens)): the chunked CE
    plus ``MOE_AUX_WEIGHT`` times the MoE load-balancing loss. Over a
    mesh the model is a :class:`ShardedLM` and the rows' sums are
    all-reduced into the same loss (its gradients into the blocks are
    ``train_step_fn``'s)."""
    if (rules or {}).get("_mesh") is not None:
        return _mesh_loss(model, batch, rules)
    hidden, _, aux = forward(model, batch["inputs"])
    ce, count = chunked_ce(hidden, model.head(), batch["targets"], model.cfg)
    loss = ce + MOE_AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux, "tokens": count}


def grad_buffers(model: ShardedLM, specs=None, entries=None) -> dict:
    """fp32 zero buffers by name for a ShardedLM's gradients, ``Sharded``
    by ``specs`` (default: the parameters' own), with blocks on every
    entry or only on ``entries``."""
    return {n: shd.Sharded.empty(p.shape, torch.float32, p.mesh,
                                 p.spec if specs is None else specs[n],
                                 fill=0.0, entries=entries)
            for n, p in reference_params(model).items()}


def train_step_fn(model, batch: dict, rules=None):
    """Plain grad step (no optimizer): returns (loss, metrics, grads), the
    grads keyed by parameter name in :func:`reference_params`' order and
    in each parameter's dtype; a parameter the loss does not reach (the
    embedding under float inputs) gets zeros, as ``jax.grad`` gives.
    Over a mesh the model is a :class:`ShardedLM` and the grads are fp32
    ``Sharded`` buffers by the parameters' specs."""
    if (rules or {}).get("_mesh") is not None:
        grads = grad_buffers(model)
        loss, metrics = _mesh_loss(model, batch, rules, grads)
        loss.backward()
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)
    params = reference_params(model)
    loss, metrics = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(params, grads)))
