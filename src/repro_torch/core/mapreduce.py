"""The paper's MapReduce layer on torch devices.

The port of ``repro/core/mapreduce.py``. Hadoop concept -> here:

  map task        -> per-shard key emission (queries their own key,
                     references every bit-flip within d)
  shuffle         -> records routed to their owner shard
                     (owner = key mod n_shards) through fixed-capacity
                     (src, dst) send buffers: ``recv[dst][src] =
                     send[src][dst]``, the reference's ``all_to_all``
  reduce-by-key   -> on-owner sort by key + segment-boundary cross product
  speculative     -> hot-bucket salting: references in a bucket past a
  re-execution       threshold are re-keyed by a salt and queries
                     replicated over every salt, so no reducer receives a
                     skewed bucket

The reference's mesh becomes ``devices``: one torch device per shard,
repeats allowed, one process, no ``torch.distributed``. The shards that
share a device are stacked on a leading shard axis and each phase runs
over the stack at once; blocks bound for another device move with
``.to()``. Everything is fixed-shape: a shuffle moves at most
``capacity`` records per (src, dst) pair, and the overflow is counted in
``dropped`` per shard, never silent.

Keys are int64 tensors holding the uint32 values (torch's uint32 lacks
``%``, shifts and sorts): ``EMPTY = 0xFFFFFFFF`` marks an empty slot, and
every XOR and shift is masked to 32 bits.

Also :func:`ring_sweep`: the streaming alternative to the shuffle — the
reference blocks go round the ring one hop per step and each resident
block is swept by the all-pairs Hamming kernel (K2 on CUDA).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import ops
from ..util import as_unsigned, group_devices, resolve_device
from .join import flip_masks

EMPTY = 0xFFFFFFFF
_M32 = 0xFFFFFFFF


def _cummax_index(flag: torch.Tensor) -> torch.Tensor:
    """For each position, the index of the last position at or before it
    where ``flag`` (..., n) holds (0 where none does)."""
    idx = torch.arange(flag.shape[-1], device=flag.device)
    return torch.cummax(torch.where(flag, idx, 0), dim=-1).values


def _segment_starts(sorted_vals: torch.Tensor) -> torch.Tensor:
    """True where a run of equal values begins, along the last axis."""
    first = torch.ones_like(sorted_vals[..., :1], dtype=torch.bool)
    return torch.cat([first, sorted_vals[..., 1:] != sorted_vals[..., :-1]],
                     dim=-1)


# ----------------------------------------------------------------- shuffle
def _pack_send(keys: torch.Tensor, payload: torch.Tensor, *, n_shards: int,
               capacity: int):
    """The map side of the shuffle for a stack of shards: keys (G, n),
    payload (G, n, p) -> send keys (G, n_shards, capacity), send payload
    (G, n_shards, capacity, p) and dropped (G,). Records go to row
    ``key % n_shards`` in their stable arrival order; the ones past
    ``capacity`` are counted, and empty slots hold EMPTY and -1."""
    G, n = keys.shape
    dev = keys.device
    dst = torch.where(keys == EMPTY, -1, keys % n_shards)
    order = torch.sort(torch.where(dst < 0, n_shards, dst), dim=1,
                       stable=True).indices
    dst_s = dst.gather(1, order)
    pos = torch.arange(n, device=dev) - _cummax_index(
        _segment_starts(dst_s))
    ok = (dst_s >= 0) & (pos < capacity)
    g, i = torch.nonzero(ok, as_tuple=True)
    flat = dst_s[g, i] * capacity + pos[g, i]
    src = order[g, i]
    send_k = torch.full((G, n_shards * capacity), EMPTY, dtype=torch.int64,
                        device=dev)
    send_k[g, flat] = keys[g, src]
    p = payload.shape[2:]
    send_p = torch.full((G, n_shards * capacity) + p, -1,
                        dtype=payload.dtype, device=dev)
    send_p[g, flat] = payload[g, src]
    dropped = ((dst_s >= 0) & ~ok).sum(1)
    return (send_k.reshape(G, n_shards, capacity),
            send_p.reshape((G, n_shards, capacity) + p), dropped)


def _exchange(sends, groups, n_shards: int):
    """The all-to-all: per group, its received (G_dst, n_shards * cap, ...)
    buffer, source-major — ``recv[dst][src] = send[src][dst]``. ``sends``
    holds one (G, n_shards, cap, ...) send stack per group. A single
    stack is one transpose; across devices each (src, dst) block moves
    with ``.to()``."""
    if len(groups) == 1:
        t = sends[0].transpose(0, 1)
        return [t.reshape((n_shards, -1) + t.shape[3:])]
    by_src = {}
    for (_, members), send in zip(groups, sends):
        for j, s in enumerate(members):
            by_src[s] = send[j]
    out = []
    for dev, members in groups:
        rows = [torch.cat([by_src[src][dst].to(dev)
                           for src in range(n_shards)], dim=0)
                for dst in members]
        out.append(torch.stack(rows))
    return out


def shuffle_records(keys: torch.Tensor, payload: torch.Tensor, *,
                    n_shards: int, capacity: int):
    """Route (key, payload) records to owner shard = key % n_shards, for
    every shard at once on one device.

    keys: (n_shards, n) int64 holding uint32 keys, EMPTY marking an empty
    slot; payload: (n_shards, n, p) int32 — shard s's records in row s.
    Returns (keys' (n_shards, n_shards*capacity), payload'
    (n_shards, n_shards*capacity, p), dropped (n_shards,)): each shard's
    received records, source shard by source shard, and each source's
    count of records that did not fit its (src, dst) buffer.
    """
    if keys.shape[0] != n_shards:
        raise ValueError(f"keys hold {keys.shape[0]} shards, expected "
                         f"{n_shards}")
    send_k, send_p, dropped = _pack_send(keys, payload, n_shards=n_shards,
                                         capacity=capacity)
    groups = [(keys.device, list(range(n_shards)))]
    (recv_k,) = _exchange([send_k], groups, n_shards)
    (recv_p,) = _exchange([send_p], groups, n_shards)
    return recv_k, recv_p, dropped


# ----------------------------------------------------------------- salting
def salt_hot_keys(keys: torch.Tensor, *, hot_threshold: int, n_salt: int,
                  is_query: torch.Tensor):
    """Split oversized buckets: references in a hot bucket get
    ``key ^= salt << 24`` with ``salt = position % n_salt + 1``; queries
    keep their key (the caller replicates them over every salt). keys
    (..., n) int64 holding uint32, is_query (..., n) bool.

    Returns (new_keys, hot_mask). Detection is per shard (the last axis),
    as in the reference: a key is hot when more than ``hot_threshold`` of
    the shard's records carry it. Salting only re-buckets; the exact
    filter runs after the join. (The reference's ``replicate_queries``
    flag, unused there, is not carried over.)
    """
    ks, order = torch.sort(keys, dim=-1)
    seg_id = torch.cumsum(_segment_starts(ks).to(torch.int64), dim=-1) - 1
    counts = torch.zeros_like(seg_id).scatter_add_(
        -1, seg_id, torch.ones_like(seg_id))
    hot_sorted = counts.gather(-1, seg_id) > hot_threshold
    hot = torch.zeros_like(hot_sorted).scatter_(-1, order, hot_sorted)
    n = keys.shape[-1]
    salt = torch.arange(n, device=keys.device) % n_salt + 1
    salted = keys ^ ((salt << 24) & _M32)
    return torch.where(hot & ~is_query, salted, keys), hot


# ----------------------------------------------------------------- reduce
def reduce_join(keys: torch.Tensor, payload: torch.Tensor, *,
                max_pairs: int):
    """Per-owner reduce: group by key, emit query x reference cross
    products (Algorithm 4 of the paper).

    keys (n,) or (G, n) int64 holding uint32; payload rows are
    (seq_id, is_query), (n, 2) or (G, n, 2). Rows sort by (key, queries
    first, arrival) — two stable sorts, the reference's ``lexsort`` — and
    every reference row emits pairs against its bucket's query prefix,
    slot for slot as the reference lays them out. Returns (pairs
    (max_pairs, 2) int32, -1 past the count; total, the true number of
    pairs, which exceeds max_pairs when the buffer truncated), with a
    leading G axis when the inputs have one.
    """
    if keys.dim() == 1:
        pairs, total = reduce_join(keys[None], payload[None],
                                   max_pairs=max_pairs)
        return pairs[0], total[0]
    G, n = keys.shape
    dev = keys.device
    is_q = payload[..., 1] == 1
    by_flag = torch.sort(torch.where(is_q, 0, 1), dim=1,
                         stable=True).indices
    order = by_flag.gather(1, torch.sort(keys.gather(1, by_flag), dim=1,
                                         stable=True).indices)
    ks = keys.gather(1, order)
    ids = payload[..., 0].gather(1, order).to(torch.int64)
    qflag = is_q.gather(1, order)
    valid = ks != EMPTY
    seg = _segment_starts(ks)
    seg_id = torch.cumsum(seg.to(torch.int64), dim=1) - 1
    qcount = torch.zeros((G, n), dtype=torch.int64, device=dev).scatter_add_(
        1, seg_id, (qflag & valid).to(torch.int64))
    nq = qcount.gather(1, seg_id)
    seg_start = _cummax_index(seg)
    emit = torch.where(valid & ~qflag, nq, 0)
    offsets = torch.cat([torch.zeros((G, 1), dtype=torch.int64, device=dev),
                         torch.cumsum(emit, dim=1)], dim=1)
    total = offsets[:, -1]
    slots = torch.arange(max_pairs, device=dev).expand(G, -1).contiguous()
    row = (torch.searchsorted(offsets, slots, right=True) - 1).clamp(0,
                                                                     n - 1)
    j = slots - offsets.gather(1, row)
    ok = slots < total[:, None]
    q_idx = (seg_start.gather(1, row) + j).clamp(0, n - 1)
    qid = torch.where(ok, ids.gather(1, q_idx), -1)
    rid = torch.where(ok, ids.gather(1, row), -1)
    return torch.stack([qid, rid], dim=-1).to(torch.int32), total


# ----------------------------------------------------------------- engine
@dataclass(frozen=True)
class MapReduceConfig:
    n_shards: int
    shuffle_capacity: int = 4096     # records per (src, dst) shard pair
    max_pairs_per_shard: int = 8192
    hot_threshold: int = 64
    n_salt: int = 4
    salting: bool = True


def _shard_devices(n: int, devices, default: torch.device):
    devs = ([default] * n if devices is None
            else [resolve_device(d) for d in devices])
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices for {n} shards: name one "
                         f"device per shard")
    return devs


def _blocks(x: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """Axis 0 split into n equal shard blocks: (n, rows/n, ...)."""
    if x.shape[0] % n:
        raise ValueError(f"{name} has {x.shape[0]} rows, not a multiple of "
                         f"{n} shards (pad with id -1 rows)")
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def _map_records(qs, rs, qi, ri, masks, cfg: MapReduceConfig):
    """The map phase for a stack of shards: (keys (G, n), payload
    (G, n, 2)) — queries emit their own key, references one key per
    flip mask, hot references are salted and queries replicated over
    every salt; rows with id < 0 are padding and carry EMPTY."""
    G, nq = qi.shape
    M = masks.shape[0]
    qk = as_unsigned(qs[..., 0])
    rk = (as_unsigned(rs[..., 0])[..., None] ^ masks).reshape(G, -1)
    rid = ri.repeat_interleave(M, dim=1)
    keys = torch.cat([qk, rk], dim=1)
    ids = torch.cat([qi, rid], dim=1)
    isq = torch.cat([torch.ones_like(qi), torch.zeros_like(rid)], dim=1)
    keys = torch.where(ids >= 0, keys, EMPTY)
    if cfg.salting:
        keys, _ = salt_hot_keys(keys, hot_threshold=cfg.hot_threshold,
                                n_salt=cfg.n_salt, is_query=isq == 1)
        salts = (torch.arange(cfg.n_salt + 1, device=keys.device) << 24) & _M32
        qk_rep = (keys[:, :nq, None] ^ salts).reshape(G, -1)
        qi_rep = qi.repeat_interleave(cfg.n_salt + 1, dim=1)
        keys = torch.cat([qk_rep, keys[:, nq:]], dim=1)
        ids = torch.cat([qi_rep, ids[:, nq:]], dim=1)
        isq = torch.cat([torch.ones_like(qi_rep), isq[:, nq:]], dim=1)
        keys = torch.where(ids >= 0, keys, EMPTY)
    return keys, torch.stack([ids, isq], dim=-1).to(torch.int32)


def distributed_flip_join(q_sigs, r_sigs, q_ids, r_ids, *, f: int, d: int,
                          cfg: MapReduceConfig, devices=None):
    """The paper's Signature Processor as map -> shuffle -> reduce over
    ``cfg.n_shards`` shards, one on each of ``devices`` (default: all on
    ``q_sigs``'s device).

    q_sigs/r_sigs: (Nq, 1)/(Nr, 1) int32 bit patterns (f <= 32), split
    into n_shards equal blocks on axis 0 (rows with id < 0 are padding);
    q_ids/r_ids: global sequence ids (int32). Returns (pairs
    (n_shards * max_pairs, 2) int32, counts (n_shards,), dropped
    (n_shards,)) on the first device, laid out shard by shard as the
    reference's ``out_specs=P(ax)``. Salted keys can collide, so the
    caller exact-filters the pairs (ids index the signatures).
    """
    if f > 32:
        raise ValueError("distributed_flip_join keys are single 32-bit "
                         "words (f <= 32)")
    n = cfg.n_shards
    devs = _shard_devices(n, devices, q_sigs.device)
    groups = group_devices(devs)
    masks_np = flip_masks(f, d)[:, 0].astype(np.int64)
    blocks = [_blocks(x, n, name) for x, name in (
        (q_sigs, "q_sigs"), (r_sigs, "r_sigs"),
        (q_ids.to(torch.int64), "q_ids"), (r_ids.to(torch.int64), "r_ids"))]
    sends_k, sends_p, dropped = [], [], [None] * n
    for dev, members in groups:
        sel = torch.tensor(members)
        qs, rs, qi, ri = (b.index_select(0, sel.to(b.device)).to(dev)
                          for b in blocks)
        keys, payload = _map_records(qs, rs, qi, ri,
                                     torch.from_numpy(masks_np).to(dev), cfg)
        send_k, send_p, drop = _pack_send(
            keys, payload, n_shards=n, capacity=cfg.shuffle_capacity)
        sends_k.append(send_k)
        sends_p.append(send_p)
        for j, s in enumerate(members):
            dropped[s] = drop[j]
    recv_k = _exchange(sends_k, groups, n)
    recv_p = _exchange(sends_p, groups, n)
    pairs, counts = [None] * n, [None] * n
    for (dev, members), k, p in zip(groups, recv_k, recv_p):
        pr, tot = reduce_join(k, p, max_pairs=cfg.max_pairs_per_shard)
        for j, s in enumerate(members):
            pairs[s], counts[s] = pr[j], tot[j]
    lead = devs[0]
    return (torch.cat([p.to(lead) for p in pairs], dim=0),
            torch.stack([c.to(lead) for c in counts]),
            torch.stack([x.to(lead) for x in dropped]))


def ring_sweep(q_sigs, r_sigs, *, d: int, devices=None,
               max_pairs_per_shard: int = 8192, q_ids=None, r_ids=None):
    """Streaming all-pairs sweep, exact (no candidate generation): shard
    s holds query block s and starts with reference block s; at each hop
    every reference block moves one shard on (``.to()`` between devices),
    so at hop h shard s sweeps reference block ``(s - h) mod n`` — the
    reference's ``ppermute`` order. Each sweep is the all-pairs Hamming
    distance of the resident blocks (K2 on CUDA, its twin on the CPU);
    its hits, in row-major order, fill the shard's buffer from its count
    on, as far as ``max_pairs_per_shard`` goes.

    ``devices``: one device per shard, repeats allowed (default: one
    shard on ``q_sigs``'s device). Returns (pairs (n * max_pairs, 2)
    int32, -1 past each shard's count; counts (n,)) on the first device.
    A shard's count is the reference's: the sum over hops of
    ``min(hits, max_pairs_per_shard)``.
    """
    devs = _shard_devices(1 if devices is None else len(devices), devices,
                          q_sigs.device)
    n = len(devs)
    if q_ids is None:
        q_ids = torch.arange(q_sigs.shape[0], dtype=torch.int32)
    if r_ids is None:
        r_ids = torch.arange(r_sigs.shape[0], dtype=torch.int32)
    qb = [b.to(dev) for b, dev in zip(_blocks(q_sigs, n, "q_sigs"), devs)]
    qib = [b.to(dev) for b, dev in zip(_blocks(q_ids.to(torch.int64), n,
                                               "q_ids"), devs)]
    rb = [b.to(dev) for b, dev in zip(_blocks(r_sigs, n, "r_sigs"), devs)]
    rib = [b.to(dev) for b, dev in zip(_blocks(r_ids.to(torch.int64), n,
                                               "r_ids"), devs)]
    cap = max_pairs_per_shard
    pairs = [torch.full((cap, 2), -1, dtype=torch.int32, device=dev)
             for dev in devs]
    counts = [0] * n
    for hop in range(n):
        for s in range(n):
            rblk, rids = rb[s], rib[s]
            dist = ops.all_pairs_hamming(qb[s], rblk)
            hit = ((dist <= d) & (qib[s][:, None] >= 0)
                   & (rids[None, :] >= 0))
            qq, rr = torch.nonzero(hit, as_tuple=True)   # row-major
            nh = min(len(qq), cap)
            room = max(0, min(nh, cap - counts[s]))
            if room:
                pairs[s][counts[s]:counts[s] + room] = torch.stack(
                    [qib[s][qq[:room]], rids[rr[:room]]],
                    dim=-1).to(torch.int32)
            counts[s] += nh
        if hop < n - 1:     # each block moves one shard on
            rb = [rb[(s - 1) % n].to(devs[s]) for s in range(n)]
            rib = [rib[(s - 1) % n].to(devs[s]) for s in range(n)]
    lead = devs[0]
    return (torch.cat([p.to(lead) for p in pairs], dim=0),
            torch.tensor(counts, dtype=torch.int64, device=lead))
