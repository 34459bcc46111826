"""Shared transformer layers: norms, RoPE, chunked GQA attention, MLP, MoE.

The port of ``repro/models/layers.py``, as plain functions on tensors with
the reference's arithmetic step for step (dtypes, masking constants, the
order of the online-softmax combine), so that a parameter dict carried
over from the JAX package gives the same numbers.

Attention is blockwise ("flash"-style online softmax over KV chunks, one
loop over query chunks), so a long prefill never materializes an (S, S)
score matrix. Its products are ``torch.einsum`` calls: the JAX package
computes them outside any Pallas kernel, so no hand-written kernel is
due, and no library attention is used.

Over a mesh, the sublayers run per entry of a DP row (``model.py``):
:func:`mlp_block` given an entry's hidden columns returns its partial
output; :func:`attention_entries` (by heads, unevenly where "model" does
not divide them) and :func:`moe_entries` take every computing entry's
input and weights at once, since their entries trade values mid-way
(q's heads for the sequence-parallel decode, the fresh k/v for the
cache, the router's logits). A cache whose leaves are
``Sharded`` takes one of two routes: single-token decode of a
global-attention layer runs sequence-parallel
(:func:`seq_sharded_decode_attention`), anything else gathers each
entry's kv heads of the row's cache onto it, runs the plain route and
writes the region back into the blocks. The reference's sharding
constraints have no counterpart (see ``sharding.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import sharding as shd
from .sharding import dp_axes, split_units

NEG_INF = -1e30


# ------------------------------------------------------------ norms
def rmsnorm(x, scale, eps: float = 1e-6):
    """x times the fp32 rsqrt of its mean square, cast back to x's dtype
    before the scale (as the reference rounds it)."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x, scale, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)   # jnp.var divides by n
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale


def norm(x, scale, kind: str):
    return rmsnorm(x, scale) if kind == "rmsnorm" else layernorm(x, scale)


# ------------------------------------------------------------ RoPE
def rope(x, positions, theta: float):
    """x: (B, S, H, Dh); positions: (S,) int. Standard rotary embedding in
    fp32, cast back to x's dtype. Negative positions (empty cache slots)
    are clamped — those slots are masked out of attention anyway."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.clamp_min(0).float()[:, None] * freqs       # (S, half)
    cos = ang.cos()[None, :, None, :]
    sin = ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention
def _attend_chunk(q, k, v, mask, scale):
    """q (B,qc,Kh,G,Dh) k/v (B,kc,Kh,Dh) mask (B|1,qc,kc) -> (acc, m, l).
    Scores are rounded to q's dtype before the fp32 scale; the
    accumulator is in v's dtype."""
    s = torch.einsum("bqkgd,bckd->bqkgc", q, k).float() * scale
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                        # (B,qc,Kh,G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bqkgc,bckd->bqkgd", p.to(v.dtype), v)
    return acc, m, l


def flash_attention(q, k, v, *, q_pos, k_pos, causal: bool,
                    window: int | None, chunk: int,
                    causal_skip: bool = False):
    """Blockwise online-softmax attention with explicit position vectors.

    q: (B, Sq, H, Dh); k, v: (B, Skv, Kh, Dh). GQA by a grouped einsum
    (no repeated KV). q_pos (Sq,), k_pos (Skv,) are absolute positions;
    key slots with k_pos < 0 are invalid (empty cache slots). Padded
    query rows get position -10**9, padded key slots -1. A fully masked
    chunk gives m = -1e30, which the combine's exp(m - m_new) removes.
    Returns (B, Sq, H, Dh).

    causal_skip: the triangular schedule — query block i scans KV blocks
    0..i only. For causal self-attention the blocks it skips are fully
    masked, and their combine factor is exactly 0, so both schedules give
    the same numbers; the skip halves the work.
    """
    B, Sq, H, Dh = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = 1.0 / math.sqrt(Dh)
    qc, kc = min(chunk, Sq), min(chunk, Skv)
    nq, nk = -(-Sq // qc), -(-Skv // kc)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * qc - Sq)).reshape(B, nq, qc, Kh, G, Dh)
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * kc - Skv)).reshape(B, nk, kc, Kh, Dh)
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * kc - Skv)).reshape(B, nk, kc, Kh, Dh)
    qpos = F.pad(q_pos, (0, nq * qc - Sq), value=-(10**9)).reshape(nq, qc)
    kpos = F.pad(k_pos, (0, nk * kc - Skv), value=-1).reshape(nk, kc)
    triangular = causal_skip and causal and window is None and nq > 1

    outs = []
    for i in range(nq):
        qb, qpo = qp[:, i], qpos[i]
        acc = torch.zeros((B, qc, Kh, G, Dh), dtype=q.dtype, device=q.device)
        m = torch.full((B, qc, Kh, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, qc, Kh, G), dtype=torch.float32, device=q.device)
        for j in range(i + 1 if triangular else nk):
            kpo = kpos[j]
            mask = (kpo >= 0)[None, None, :]
            if causal:
                mask = mask & (qpo[None, :, None] >= kpo[None, None, :])
            if window is not None:
                mask = mask & ((qpo[None, :, None] - kpo[None, None, :])
                               < window)
            a, m2, l2 = _attend_chunk(qb, kp[:, j], vp[:, j], mask, scale)
            m_new = torch.maximum(m, m2)
            c1 = torch.exp(m - m_new)
            c2 = torch.exp(m2 - m_new)
            acc = (acc * c1[..., None].to(acc.dtype)
                   + a * c2[..., None].to(a.dtype))
            l = l * c1 + l2 * c2
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None].to(acc.dtype))
    out = torch.stack(outs, dim=1).reshape(B, nq * qc, H, Dh)
    return out[:, :Sq]


def _flash_unnormalized(q, k, v, mask, scale, chunk: int):
    """Single-q-block flash returning the raw (acc, m, l): the combinable
    form of sequence-parallel decode (a partial softmax per KV shard,
    merged across the "model" entries). q (B, Sq, Kh, G, Dh), k/v (B,
    Skv, Kh, Dh), mask (B, Sq, Skv) bool; padded keys are masked."""
    B, Sq, Kh, G, Dh = q.shape
    Skv = k.shape[1]
    kc = min(chunk, Skv)
    nk = -(-Skv // kc)
    pad = nk * kc - Skv
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    mp = F.pad(mask, (0, pad), value=False)
    acc = torch.zeros((B, Sq, Kh, G, Dh), dtype=q.dtype, device=q.device)
    m = torch.full((B, Sq, Kh, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, Kh, G), dtype=torch.float32, device=q.device)
    for j in range(nk):
        c = slice(j * kc, (j + 1) * kc)
        a, m2, l2 = _attend_chunk(q, kp[:, c], vp[:, c], mp[:, :, c], scale)
        m_new = torch.maximum(m, m2)
        c1, c2 = torch.exp(m - m_new), torch.exp(m2 - m_new)
        acc = (acc * c1[..., None].to(acc.dtype)
               + a * c2[..., None].to(a.dtype))
        l = l * c1 + l2 * c2
        m = m_new
    return acc, m, l


def seq_shardable(S: int, window, rules, Smax: int) -> bool:
    """The reference's condition for sequence-parallel decode."""
    mesh = (rules or {}).get("_mesh")
    return (S == 1 and window is None and mesh is not None
            and rules.get("kv_seq") == "model"
            and Smax % mesh.axis_size("model") == 0)


def seq_sharded_decode_attention(q, cache, k_new, v_new, positions, cfg,
                                 mesh, *, causal=True, rows=None):
    """Single-token decode against a KV cache whose SEQUENCE axis is
    sharded over the "model" entries (sequence-parallel serving).

    q: (B, 1, H, Dh) of the DP ``rows`` (default: every row of the mesh
    for the batch) in order, on the first row's device; cache k / v
    ``Sharded`` (B, Smax, Kh, Dh) by (batch over DP, "model", None,
    None), pos (Smax,) by ("model",); k_new / v_new (B, 1, Kh, Dh);
    positions (1,) absolute. For each row and each of its model entries,
    on that entry's device: write the slot where it falls inside the
    entry's range (a device-side select, as the reference's), rope the
    local keys and take the partial flash over the local slice; the
    partials then merge on the row's device as the reference's pmax/psum
    do: m_g = max, corr = exp(m - m_g), l_g = sum(l·corr), acc_g =
    sum(acc·corr) in fp32, out = acc_g / max(l_g, 1e-30) in q's dtype.
    The cache is updated in place. Inside ``mesh.walk`` only the walked
    entries compute: the home's partial stands in for another's in the
    merge. Returns (out (B, 1, H, Dh), cache).
    """
    B, S, H, Dh = q.shape
    Kh = k_new.shape[2]
    G = H // Kh
    scale = 1.0 / math.sqrt(Dh)
    K, V, Pc = cache["k"], cache["v"], cache["pos"]
    Smax = K.shape[1]
    if K.spec[1:2] != ("model",) or Pc.spec != ("model",):
        raise ValueError(f"the cache's seq axis is not on 'model': "
                         f"k {K.spec}, pos {Pc.spec}")
    if rows is None:
        rows = mesh.rows(dp_axes(mesh), B)
    outs, off = [], 0
    for row in rows:
        rs = slice(off, off + row.size)
        off += row.size
        ins = [mesh.spread(t, row.home, row.entries, "collective-permute")
               for t in (q[rs], k_new[rs], v_new[rs], positions)]
        parts = {}
        for e in mesh.computing(row.entries):
            qL, kN, vN, pos = (t[e] for t in ins)
            kC, vC, pC = K.blocks[e], V.blocks[e], Pc.blocks[e]
            lo, hi = Pc.boxes[e][0]
            Bl, Sloc = qL.shape[0], hi - lo
            slot_l = torch.remainder(pos[:1], Smax) - lo
            inside = (slot_l >= 0) & (slot_l < Sloc)
            sl = slot_l.clamp(0, Sloc - 1).long()
            kC.index_copy_(1, sl, torch.where(inside, kN,
                                              kC.index_select(1, sl)))
            vC.index_copy_(1, sl, torch.where(inside, vN,
                                              vC.index_select(1, sl)))
            pC.index_copy_(0, sl, torch.where(inside, pos[:1].to(pC.dtype),
                                              pC.index_select(0, sl)))
            kR = rope(kC, pC, cfg.rope_theta)
            mask = (pC >= 0)[None, None, :]
            if causal:
                mask = mask & (pos[0] >= pC)[None, None, :]
            mask = mask.expand(Bl, S, Sloc)
            parts[e] = _flash_unnormalized(qL.reshape(Bl, S, Kh, G, Dh),
                                           kR, vC, mask, scale,
                                           cfg.attn_chunk)
        parts = list(zip(*(mesh.gather({e: p[i] for e, p in parts.items()},
                                       row.entries, row.home, "all-reduce")
                           for i in range(3))))
        m_g = parts[0][1]
        for _, m, _ in parts[1:]:
            m_g = torch.maximum(m_g, m)
        l_g = acc_g = None
        for acc, m, l in parts:
            corr = torch.exp(m - m_g)
            lc = l * corr
            ac = (acc * corr[..., None].to(acc.dtype)).float()
            l_g = lc if l_g is None else l_g + lc
            acc_g = ac if acc_g is None else acc_g + ac
        out = (acc_g / l_g.clamp_min(1e-30)[..., None]).to(q.dtype)
        outs.append(out.reshape(-1, S, H, Dh))
    out = outs[0] if len(outs) == 1 else torch.cat(
        [mesh.move(o, r.home, rows[0].home, "all-gather")
         for o, r in zip(outs, rows)])
    return out, cache


def gather_pieces(mesh, parts: dict, want, dst: int, dim: int):
    """The pieces of entries ``want`` (``parts``: entry -> tensor)
    all-gathered onto ``dst`` and concatenated along ``dim``."""
    out = mesh.gather(parts, want, dst, "all-gather")
    return out[0] if len(out) == 1 else torch.cat(out, dim)


def _attend_sharded_cache(qkv, cache, positions, cfg, row, heads, causal,
                          window):
    """Attention over a cache of ``Sharded`` leaves: for each computing
    entry, the row's region of its kv heads gathered onto it (a copy),
    the plain route there; then each distinct region written back to the
    row's entries' blocks by its first entry (its new slots among it),
    pos by the first."""
    Smax, hd = cache["k"].shape[1], cache["k"].shape[3]
    outs, copies = {}, {}
    for e, (q, k, v) in qkv.items():
        lo, hi = heads[e][2:4]
        region = ((row.start, row.start + row.size), (0, Smax), (lo, hi),
                  (0, hd))
        plain = {n: cache[n].read(e, region, prefer=row.entries)
                 for n in ("k", "v")}
        plain["pos"] = cache["pos"].read(e, prefer=row.entries)
        # a read inside one block is a view of it: the route writes in place
        plain = {n: t.clone() if t._base is not None else t
                 for n, t in plain.items()}
        outs[e] = _attend_cache(q, k, v, plain, positions[e], cfg, causal,
                                window, _kv_index(cfg, heads[e]))
        copies.setdefault(region, (e, plain))
    for region, (e, plain) in copies.items():
        for n in ("k", "v"):
            cache[n].write(plain[n], e, region, entries=row.entries)
    e, plain = next(iter(copies.values()))
    cache["pos"].write(plain["pos"], e, entries=row.entries)
    return outs


def _per_q(t, idx):
    """k or v with their kv heads taken per q head (``idx``), or as they
    are (None)."""
    return t if idx is None else t[:, :, idx]


def _attend_cache(q, k, v, cache, positions, cfg, causal, window,
                  kv_index=None):
    """Attention over a plain cache dict, updated in place. ``kv_index``:
    the kv head (of those given) each q head reads, where the grouped
    form cannot say it (:func:`_kv_index`)."""
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    S, Smax = q.shape[1], ck.shape[1]
    if S == 1:
        # Single-token decode: write-then-attend is exact (the slot
        # written IS the current position; a ring overwrite only evicts
        # pos - Smax, which the window predicate masks anyway).
        _write(ck, cv, cpos, k, v, positions)
        return flash_attention(q, _per_q(rope(ck, cpos, cfg.rope_theta),
                                         kv_index), _per_q(cv, kv_index),
                               q_pos=positions, k_pos=cpos, causal=causal,
                               window=window, chunk=cfg.attn_chunk)
    # Chunked prefill: attend BEFORE writing (a ring write of a
    # multi-token chunk would clobber keys that early queries of the
    # chunk still need), over concat(cache, fresh); stale ring entries
    # are masked by the window, empty slots by pos == -1.
    pos_all = torch.cat([cpos, positions])
    k_roped = rope(torch.cat([ck, k], dim=1), pos_all, cfg.rope_theta)
    out = flash_attention(q, _per_q(k_roped, kv_index),
                          _per_q(torch.cat([cv, v], dim=1), kv_index),
                          q_pos=positions, k_pos=pos_all, causal=causal,
                          window=window, chunk=cfg.attn_chunk)
    # Only the last Smax positions are written, so no slot is written
    # twice: the reference's scatter writes every position and a ring
    # slot more than once past the window, which the CPU resolves as
    # last-write-wins but a CUDA index-put leaves in no defined order.
    # On the CPU both give the same cache.
    w = min(S, Smax)
    _write(ck, cv, cpos, k[:, S - w:], v[:, S - w:], positions[S - w:])
    return out


def _qkv(x, p, cfg, positions):
    """The pre-norm projections: q (B, S, n, hd) roped, its head count
    read off the weights (an entry's share holds fewer); k and v
    unroped, (B, S, w) over the columns of the weights given."""
    B, S, _ = x.shape
    h = norm(x, p["norm"], cfg.norm_type)
    q = (h @ p["wq"]).reshape(B, S, -1, cfg.hd)
    return rope(q, positions, cfg.rope_theta), h @ p["wk"], h @ p["wv"]


def _self_attend(q, k, v, positions, cfg, causal, window, kv_index=None):
    return flash_attention(q, _per_q(rope(k, positions, cfg.rope_theta),
                                     kv_index), _per_q(v, kv_index),
                           q_pos=positions, k_pos=positions, causal=causal,
                           window=window, chunk=cfg.attn_chunk,
                           causal_skip=cfg.causal_skip)


def attention_block(x, p, cfg, *, positions, causal: bool,
                    window: int | None, cache=None):
    """Pre-norm GQA attention with an optional KV cache (decode).

    p: dict(wq (d, H*hd), wk/wv (d, Kh*hd), wo_attn (H*hd, d), norm (d,));
    H and Kh are read off the weights. cache: None | dict(k (B, Smax,
    Kh, hd) UNROPED, v likewise, pos (Smax,) absolute positions, -1 =
    empty). Windowed layers use a ring buffer (Smax == window), global
    layers a linear one; K is roped at use time from the stored
    positions, so ring overwrites stay correct. The cache's tensors are
    updated IN PLACE (the reference returns new arrays); the returned
    dict holds them. Over a mesh see :func:`attention_entries`. Returns
    (out, new_cache).
    """
    B, S, _ = x.shape
    q, k, v = _qkv(x, p, cfg, positions)
    k, v = (t.reshape(B, S, -1, cfg.hd) for t in (k, v))
    if cache is None:
        out = _self_attend(q, k, v, positions, cfg, causal, window)
    else:
        out = _attend_cache(q, k, v, cache, positions, cfg, causal, window)
    return out.reshape(B, S, -1) @ p["wo_attn"], cache


def entry_heads(cfg, row) -> dict:
    """Each entry of ``row``'s attention share: (first q head, end q
    head, first kv head, end kv head, first kv column, end kv column).
    The q heads split in "model" order by ``sharding.split_units``
    (evenly where "model" divides them, else the first H mod m entries
    take one more; an entry may take none); under GQA q head h reads kv
    head h // (H / Kh), and an entry reads the kv heads its q heads
    read. The entries that read a kv head split its hd columns of the
    k and v projections (``split_units``, in order), so each computes
    the columns [first, end) of them and gathers the rest of its kv
    heads from the others (:func:`_kv_heads`)."""
    G, hd = cfg.n_heads // cfg.n_kv_heads, cfg.hd
    q = dict(zip(row.entries, split_units(cfg.n_heads, len(row.entries))))
    kv = {e: (a // G, (b - 1) // G + 1) if b > a else (0, 0)
          for e, (a, b) in q.items()}
    cols = {}
    for j in range(cfg.n_kv_heads):
        readers = [e for e in row.entries if kv[e][0] <= j < kv[e][1]]
        for e, (c0, c1) in zip(readers, split_units(hd, len(readers))):
            lo, hi = cols.get(e, (j * hd + c0, j * hd + c1))
            cols[e] = (lo, j * hd + c1)
    return {e: (*q[e], *kv[e], *cols.get(e, (0, 0))) for e in row.entries}


def _kv_heads(mesh, row, heads, own, hd):
    """Each computing entry's kv heads of k (or v) (B, S, n, hd), from
    ``own`` (entry -> (B, S, w), the columns it computed): its own and
    the rest moved from the entries that computed them (an all-gather
    among the readers of a kv head; inside ``Mesh.walk``, zeros stand
    in for a piece not computed)."""
    out = {}
    for e, t in own.items():
        lo, hi = heads[e][2] * hd, heads[e][3] * hd
        pieces = []
        for o in row.entries:
            o0, o1 = heads[o][4:]
            x0, x1 = max(lo, o0), min(hi, o1)
            if x0 >= x1:
                continue
            if o in own:
                piece = own[o][..., x0 - o0:x1 - o0]
            else:
                piece = shd.stand_in_like(t, t.shape[:-1] + (x1 - x0,))
            pieces.append(piece if o == e else mesh.move(piece, o, e,
                                                         "all-gather"))
        k = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)
        out[e] = k.reshape(*t.shape[:2], -1, hd)
    return out


def _kv_index(cfg, share):
    """The kv head (of the share's) each of its q heads reads, where its
    q heads do not read its kv heads in equal runs (say heads 4-7 of
    qwen2-vl's groups of 7: three read kv head 0, one kv head 1), so
    the grouped einsum cannot; None where it can."""
    a, b, lo, hi = share[:4]
    G = cfg.n_heads // cfg.n_kv_heads
    runs = {sum(h // G == kv for h in range(a, b)) for kv in range(lo, hi)}
    return None if len(runs) == 1 else [h // G - lo for h in range(a, b)]


def _gather_heads(mesh, pieces: dict, counts: dict, home: int):
    """The heads of ``counts``' entries (entry -> its head count, in head
    order) from ``pieces`` (entry -> (B, S, n, Dh), those that computed)
    on ``home``, concatenated on the head axis; inside ``Mesh.walk``,
    zeros of an entry's count stand in for its piece."""
    def stand_in(e, own):
        return shd.stand_in_like(own, own.shape[:2] + (counts[e],)
                                 + own.shape[3:])
    return torch.cat(mesh.gather(pieces, list(counts), home, "all-gather",
                                 stand_in), dim=2)


def attention_entries(xs, ps, cfg, rules, *, row, positions, causal: bool,
                      window: int | None, cache=None):
    """Attention over a mesh row, tensor-parallel by heads
    (:func:`entry_heads`): ``xs`` and ``ps`` map each computing entry
    that has q heads to its input (B_r, S, d) and weights on its device
    — its q heads' columns of ``wq`` and rows of ``wo_attn``, its
    columns of ``wk``/``wv`` (the rest of its kv heads' k and v are
    gathered from the entries that computed them). Returns each one's
    partial output (its heads through its rows of ``wo_attn``), which
    the row all-reduces (an entry without heads adds nothing).

    With a ``Sharded`` cache: the sequence-parallel decode takes every q
    head (the reference's ``shard_map`` takes q replicated), so q's heads
    and each kv head (from the first entry that computed it) are
    all-gathered onto the home, the merged output goes back to each
    entry for its heads; otherwise :func:`_attend_sharded_cache`.
    ``positions``: on the home's device.
    """
    mesh = rules["_mesh"]
    home = row.home
    pos = {e: positions.to(mesh.devices[e]) for e in xs}
    qkv = {e: _qkv(xs[e], ps[e], cfg, pos[e]) for e in xs}
    heads = entry_heads(cfg, row)
    ks, vs = (_kv_heads(mesh, row, heads, {e: t[i] for e, t in qkv.items()},
                        cfg.hd) for i in (1, 2))
    qkv = {e: (t[0], ks[e], vs[e]) for e, t in qkv.items()}
    B, S = next(iter(xs.values())).shape[:2]
    if cache is None:
        outs = {e: _self_attend(q, k, v, pos[e], cfg, causal, window,
                                _kv_index(cfg, heads[e]))
                for e, (q, k, v) in qkv.items()}
    elif seq_shardable(S, window, rules, cache["k"].shape[1]):
        ents = [e for e in row.entries if heads[e][1] > heads[e][0]]
        q = _gather_heads(mesh, {e: t[0] for e, t in qkv.items()},
                          {e: heads[e][1] - heads[e][0] for e in ents}, home)
        kv_from, done = {}, 0       # entry -> its kv heads [lo, hi) taken
        for e in ents:
            if heads[e][3] > done:
                kv_from[e] = (done, heads[e][3])
                done = heads[e][3]

        def kv_piece(i):
            return {e: t[i][:, :, kv_from[e][0] - heads[e][2]:
                            kv_from[e][1] - heads[e][2]]
                    for e, t in qkv.items() if e in kv_from}
        k, v = (_gather_heads(mesh, kv_piece(i), {
            e: hi - lo for e, (lo, hi) in kv_from.items()}, home)
            for i in (1, 2))
        out = seq_sharded_decode_attention(q, cache, k, v, positions, cfg,
                                           mesh, causal=causal,
                                           rows=(row,))[0]
        outs = mesh.spread(out, home, ents, "all-reduce", lambda t, e: t[
            :, :, heads[e][0]:heads[e][1]])
    else:
        outs = _attend_sharded_cache(qkv, cache, pos, cfg, row, heads,
                                     causal, window)
    return {e: outs[e].reshape(B, S, -1) @ ps[e]["wo_attn"] for e in xs}


def _write(ck, cv, cpos, k, v, positions):
    """Store unroped k, v and their positions at slots pos mod Smax (each
    slot at most once)."""
    slots = (positions % ck.shape[1]).long()
    ck.index_copy_(1, slots, k)
    cv.index_copy_(1, slots, v)
    cpos.index_copy_(0, slots, positions.to(cpos.dtype))


# ------------------------------------------------------------ MLP
def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def mlp_block(x, p, cfg):
    """Pre-norm MLP: gated (SwiGLU-style) or plain, activation per config.
    Given an entry's hidden columns of the weights, its partial output."""
    h = norm(x, p["norm"], cfg.norm_type)
    u = h @ p["wi"]
    if cfg.mlp_gated:
        u = u * _act(h @ p["wg"], cfg.mlp_act)
    else:
        u = _act(u, cfg.mlp_act)
    return u @ p["wo"]


# ------------------------------------------------------------ MoE
def top_k(x, k: int):
    """The k largest entries of the last axis, ties broken toward the
    lower index (``lax.top_k``'s order; ``torch.topk`` promises none):
    a stable descending sort keeps equal entries in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits, cfg):
    """Top-k routing of one layer's tokens from their fp32 router logits
    (G, Tg, E): (probs, e_flat, slot, w_flat, C). Each (token, k) is
    ranked within its expert's queue by a stable sort over expert ids;
    a kept one goes to slot e·C + rank, a dropped one to E·C."""
    groups, Tg, E = logits.shape
    K = cfg.experts_per_token
    C = max(int(math.ceil(Tg / E * K * cfg.capacity_factor)), 4)
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                     # (G, Tg, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = gate_idx.reshape(groups, Tg * K)
    w_flat = gate_vals.reshape(groups, Tg * K)
    # rank within the expert's queue (stable sort by expert id)
    e_s, order = torch.sort(e_flat, dim=-1, stable=True)
    seg = torch.cat([torch.ones((groups, 1), dtype=torch.bool, device=dev),
                     e_s[:, 1:] != e_s[:, :-1]], dim=1)
    idx = torch.arange(Tg * K, device=dev).expand(groups, -1)
    rank_s = idx - torch.cummax(torch.where(seg, idx, 0), dim=1).values
    rank = torch.zeros_like(rank_s).scatter_(1, order, rank_s)
    slot = torch.where(rank < C, e_flat * C + rank, E * C)    # drop row
    return probs, e_flat, slot, w_flat, C


def _route_stats(probs, e_flat):
    """The groups' (me, ce) (G, E): mean router probability and the
    share of (token, k) picks per expert, times E."""
    groups, Tk = e_flat.shape
    E = probs.shape[-1]
    me = probs.mean(dim=1)
    ce = torch.zeros((groups, E), dtype=torch.float32,
                     device=probs.device).scatter_add_(
        1, e_flat, torch.ones(e_flat.shape, dtype=torch.float32,
                              device=probs.device)) / Tk * E
    return me, ce


def _experts(h, routing, p, lo: int, cfg):
    """The summed output (G·Tg, d) of experts [lo, lo + E_p) (E_p =
    ``p["ewi"]``'s first dim: an entry's experts, or all of them) for
    ``routing`` = (slot, w_flat, C): their kept (token, k) rows go to a
    fixed (E_p·C + 1, d) buffer whose last row swallows every other
    write, the experts run on (G, E_p, C, d), and the weighted outputs
    are summed back per token with ``index_add_`` (on CUDA its float sum
    order is not fixed: the K terms of a token may add in another order
    than on the CPU)."""
    groups, Tg, d = h.shape
    slot, w_flat, C = routing
    Ep = p["ewi"].shape[0]
    K = slot.shape[1] // Tg
    dev = h.device
    t_flat = torch.arange(Tg, device=dev).repeat_interleave(K)
    mine = (slot >= lo * C) & (slot < (lo + Ep) * C)
    sl = torch.where(mine, slot - lo * C, Ep * C)
    # only the drop row is written more than once, and it is discarded
    xb = h.new_zeros((groups, Ep * C + 1, d)).scatter_(
        1, sl[..., None].expand(-1, -1, d), h[:, t_flat])
    xe = xb[:, :Ep * C].reshape(groups, Ep, C, d)
    u = torch.einsum("gecd,edf->gecf", xe, p["ewi"])
    if cfg.mlp_gated:
        u = u * _act(torch.einsum("gecd,edf->gecf", xe, p["ewg"]),
                     cfg.mlp_act)
    else:
        u = _act(u, cfg.mlp_act)
    ye = torch.einsum("gecf,efd->gecd", u, p["ewo"])          # (G,Ep,C,d)
    yb = torch.cat([ye.reshape(groups, Ep * C, d),
                    ye.new_zeros((groups, 1, d))], dim=1)     # drop row = 0
    y_rec = torch.gather(yb, 1, sl[..., None].expand(-1, -1, d)) \
        * w_flat[..., None].to(ye.dtype)
    tok = (t_flat + torch.arange(groups, device=dev)[:, None] * Tg).reshape(-1)
    return ye.new_zeros((groups * Tg, d)).index_add_(
        0, tok, y_rec.reshape(-1, d))


def _groups(x):
    """Routing groups: per batch row, or the whole batch when S == 1."""
    B, S, _ = x.shape
    return (1, B) if S == 1 else (B, S)


def moe_block(x, p, cfg):
    """Dropped-token top-k MoE with sort-based dispatch.

    Routing and capacity are per routing group: per batch row, or the
    whole batch when S == 1 (decode); see :func:`_route` and
    :func:`_experts`. Over a mesh see :func:`moe_entries`. Returns (out,
    aux_loss).
    """
    B, S, d = x.shape
    groups, Tg = _groups(x)
    h = norm(x, p["norm"], cfg.norm_type).reshape(groups, Tg, d)
    probs, e_flat, slot, w_flat, C = _route(
        h.float() @ p["router"].float(), cfg)
    me, ce = _route_stats(probs, e_flat)
    out = _experts(h, (slot, w_flat, C), p, 0, cfg)
    aux = (me.mean(0) * ce.mean(0)).sum()
    return out.reshape(B, S, d), aux


def moe_entries(xs, ps, cfg, mesh, row, stats: list):
    """MoE over a mesh row, expert-parallel: ``xs`` and ``ps`` map each
    computing entry to its input (B_r, S, d) and weights — its experts'
    columns of the router and its experts of ``ewi``/``ewg``/``ewo`` —
    on its device. Each entry's router logits (G, Tg, E_p) are
    all-gathered onto every entry, which routes alike (equal inputs give
    equal integer work) and runs its experts; returns each entry's
    partial output, which the row all-reduces, and appends the home's
    (me, ce) to ``stats``."""
    x = next(iter(xs.values()))
    B, S, d = x.shape
    groups, Tg = _groups(x)
    hs = {e: norm(t, ps[e]["norm"], cfg.norm_type).reshape(groups, Tg, d)
          for e, t in xs.items()}
    logits = mesh.all_gather({e: hs[e].float() @ ps[e]["router"].float()
                              for e in xs}, row.entries, "all-gather")
    Ep = ps[row.home]["ewi"].shape[0]
    out = {}
    for e in xs:
        probs, e_flat, slot, w_flat, C = _route(torch.cat(logits[e], -1),
                                                cfg)
        if e == row.home:
            stats.append(_route_stats(probs, e_flat))
        lo = row.entries.index(e) * Ep
        out[e] = _experts(hs[e], (slot, w_flat, C), ps[e], lo,
                          cfg).reshape(B, S, d)
    return out
