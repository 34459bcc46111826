"""LSH self-join: the corpus joined against itself via the index's buckets.

The port of ``repro/allpairs/selfjoin.py`` for ``join_impl="spgemm"``.
Every bucket of the :class:`~repro_torch.index.store.SignatureIndex` emits
its own within-bucket pairs (a bucket of m members gives m*(m-1)/2), pairs
colliding in several bands are deduplicated, and the result is the exact
set of LSH band collisions: upper-triangular (i < j), valid sequences
only, sorted. With ``d=`` the exact Hamming filter keeps the
d-neighbourhood graph (the pigeonhole guarantee makes it complete).

Emission is the strict upper triangle of AᵀA over the band-stacked bucket
slabs (``index/spgemm.py``; kernel K5 on CUDA), sized from the
partition's exact int64 pair totals, so it can never truncate; the pack
(dedup, filter, compaction) runs on the lead device and the join pays
one host sync, the count. Band-layout corpora up to ``PACKED_KEY_MAX_ID``
sequences take the keyed dup-free pack, the rest (larger corpora, the
flip layout) the sort-dedup pack; both give the same arrays. The fused
prefilter (:class:`JoinPrefilter`, kernel K4 on CUDA) scores the
deduplicated device pair buffer in place.

Emission runs over the shard-owned bucket slabs of
:class:`~repro_torch.index.partition.BucketPartition` (``mix32(key) %
n_shards``, the MapReduce shuffle as a data layout). ``devices`` names one
torch device per shard, repeats allowed (default: every shard on the
index's device). Uniform per-shard demand on one device is one fused
program over every (shard, band) slab; otherwise each shard emits at its
own capacity (:func:`_shard_caps`, so one degenerate bucket inflates one
shard's buffer) on its own device, or the shards sharing a device in one
launch when their demand is uniform, and the buffers meet on the lead
device (``.to()``) for one exact-sized pack (:func:`_pack_exact`).
Buckets are never split across shards, so the result arrays are the same
for every ``n_shards``.

:func:`lsh_delta_join` emits only the pairs that touch rows appended after
``base_size``: each new segment's within-bucket pairs (K5) and its cross
pairs against every earlier segment's matching buckets, per shard under
the segments' bucket partitions (matching keys own the same shard on
both sides). Its union with the old pair set is exactly the from-scratch
self-join of the grown corpus.

``join_impl="legacy"`` is not ported, by decision (ROADMAP Queue 1 "Not
ported"); it raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.join import PACKED_KEY_MAX_ID, compact_pairs
from ..index.partition import BucketPartition, pad_slabs_pow2
from ..index.spgemm import (spgemm_cross_slab, spgemm_join_self,
                            spgemm_join_self_keys, spgemm_pack,
                            spgemm_self_slab)
from ..index.store import SignatureIndex
from ..obs import span
from ..util import group_devices, next_pow2, resolve_device

JOIN_IMPLS = ("spgemm", "legacy")


def _check_impl(join_impl: str) -> None:
    if join_impl not in JOIN_IMPLS:
        raise ValueError(f"unknown join_impl {join_impl!r} "
                         f"(expected one of {JOIN_IMPLS})")
    if join_impl == "legacy":
        raise NotImplementedError(
            "join_impl='legacy' is not ported by decision (ROADMAP Queue 1, "
            "'Not ported'): it gives the same arrays as join_impl='spgemm'")


def _resolve_devices(index: SignatureIndex, n: int, devices):
    """One torch device per shard (default: all on the index's device),
    and the shards grouped by device in order of first appearance:
    (devices, [(device, shard indices)])."""
    devs = ([index.device] * n if devices is None
            else [resolve_device(d) for d in devices])
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices for {n} shards: name one "
                         f"device per partition shard")
    return devs, group_devices(devs)


def _shard_caps(part: BucketPartition) -> np.ndarray:
    """(S,) int64 emission capacity per shard: its own max per-(shard,
    band) within-bucket pair total, quantized to the next power of two."""
    if part.pair_totals.size == 0:
        return np.zeros(part.n_shards, np.int64)
    per_shard = part.pair_totals.max(axis=1)
    return np.array([next_pow2(int(c)) for c in per_shard], np.int64)


@dataclass(frozen=True)
class JoinPrefilter:
    """Fused in-join ungapped X-drop prefilter (see :func:`lsh_self_join`).

    The deduplicated candidate buffer is scored by the ungapped diagonal
    scan on the device, straight off the device pair buffer, and only
    survivors (ungapped >= ``min_score``) are compacted and copied to the
    host. The surviving pair set equals filtering
    ``score_pairs(..., prefilter=True)`` output post hoc (same
    ``min_score``/``x``).
    """
    ids: np.ndarray         # (N, L) int8 PAD-padded corpus
    lens: np.ndarray        # (N,) int32
    min_score: int = 40     # survivors: ungapped score >= this (>= 1, so
                            # the -1 padding slots, all-PAD rows scoring 0,
                            # never survive)
    x: int | None = None    # X-drop margin (None = inf, plain best segment)
    batch: int = 256        # pairs per prefilter chunk
    len_quantum: int = 64   # gathered-length quantization


def _prefilter_join(pairs_dev: torch.Tensor, n_cand: int,
                    pf: JoinPrefilter):
    """Run the fused prefilter over a deduplicated device pair buffer.
    Returns (kept_pairs (K, 2), kept_ungapped (K,) int32) host arrays —
    the only device-to-host copy of pair data."""
    from ..align.smith_waterman import gather_rows, ungapped_xdrop_scores
    if pf.min_score < 1:
        raise ValueError("JoinPrefilter.min_score must be >= 1 (padding "
                         "slots score 0 and must never survive)")
    dev = pairs_dev.device
    lens_np = np.asarray(pf.lens, np.int32)
    ids_dev = torch.as_tensor(np.asarray(pf.ids, np.int8), device=dev)
    lens_dev = torch.as_tensor(lens_np, device=dev)
    q = pf.len_quantum
    L = int(max(q, -(-int(lens_np.max(initial=1)) // q) * q))
    cap, B = pairs_dev.shape[0], pf.batch
    # only chunks that can hold real rows are scored; rows past the count
    # are -1 (all-PAD gathers scoring 0) and can never survive
    n_eff = min(cap, -(-max(n_cand, 1) // B) * B)
    scores = torch.zeros(cap, dtype=torch.int32, device=dev)
    for s in range(0, n_eff, B):
        chunk = pairs_dev[s:s + B].long()
        qm = gather_rows(ids_dev, lens_dev, chunk[:, 0], L)
        rm = gather_rows(ids_dev, lens_dev, chunk[:, 1], L)
        scores[s:s + len(chunk)] = ungapped_xdrop_scores(qm, rm, x=pf.x)
    keep = (pairs_dev[:, 0] >= 0) & (scores >= pf.min_score)
    out, cnt = compact_pairs((pairs_dev[:, 0], pairs_dev[:, 1], scores),
                             keep, cap)
    host = out[:int(cnt)].cpu().numpy()
    return np.ascontiguousarray(host[:, :2]), np.ascontiguousarray(host[:, 2])


@dataclass(frozen=True)
class SelfJoinResult:
    """Deduplicated upper-triangular candidate set as a CSR adjacency."""
    pairs: np.ndarray      # (P, 2) int32, i < j, lexicographically sorted
    indptr: np.ndarray     # (N+1,) int64 — CSR row offsets over corpus ids
    indices: np.ndarray    # (P,) int32 — CSR column ids (the j of each pair)
    n_candidates: int      # == P
    ungapped: np.ndarray | None = None  # (P,) int32 prefilter scores of the
                                        # SURVIVING pairs (fused prefilter)
    n_prefiltered: int = 0  # candidates dropped in-join by the prefilter

    @property
    def n_rows(self) -> int:
        return len(self.indptr) - 1

    def neighbors(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i]:self.indptr[i + 1]]


def _pairs_to_csr(pairs: np.ndarray, n: int, *, ungapped=None,
                  n_prefiltered: int = 0) -> SelfJoinResult:
    rows = pairs[:, 0]
    indptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int64)
    return SelfJoinResult(pairs=pairs, indptr=indptr,
                          indices=np.ascontiguousarray(pairs[:, 1]),
                          n_candidates=len(pairs), ungapped=ungapped,
                          n_prefiltered=n_prefiltered)


def _empty(n: int) -> SelfJoinResult:
    return _pairs_to_csr(np.zeros((0, 2), np.int32), n)


def _grow_overflow(scope: str, max_grow: int):
    raise RuntimeError(
        f"{scope} exceeded max_grow={max_grow} pairs; the corpus "
        f"has a degenerate bucket — raise max_grow or increase bands/d "
        f"selectivity")


def _finish_pairs(pairs_dev: torch.Tensor, n_cand: int,
                  index: SignatureIndex,
                  prefilter: JoinPrefilter | None) -> SelfJoinResult:
    """Shared join tail off a deduplicated device pair buffer: the fused
    prefilter (survivors are the only host copy) or the plain host copy
    of the first ``n_cand`` rows."""
    if prefilter is None:
        return _pairs_to_csr(pairs_dev[:n_cand].cpu().numpy(), index.size)
    with span("join_prefilter", cat="allpairs", candidates=n_cand):
        kept, ung = _prefilter_join(pairs_dev, n_cand, prefilter)
    return _pairs_to_csr(kept, index.size, ungapped=ung,
                         n_prefiltered=n_cand - len(kept))


def _pack_exact(cand: torch.Tensor, index: SignatureIndex, d: int | None,
                total: int, limit: int, max_grow: int, scope: str,
                prefilter: JoinPrefilter | None) -> SelfJoinResult:
    """The merged tail: the pack's output is sized at the exact emission
    total (survivors <= emitted), so it never overflows. ``limit`` is the
    reference's ceiling: it raises only when the deduplicated union must
    grow past ``max_grow``."""
    out_cap = next_pow2(max(1, min(total, limit)))
    pairs, count = spgemm_pack(cand, index.device_sigs.to(cand.device),
                               out_cap=out_cap, d=d)
    n_cand = int(count)
    if n_cand > limit:
        _grow_overflow(scope, max_grow)
    return _finish_pairs(pairs, n_cand, index, prefilter)


def _merge(bufs, lead: torch.device) -> torch.Tensor:
    """Ragged merge of per-shard (..., cap, 2) buffers on the lead device
    (the pack dedups and sorts, so the order of the rows is free)."""
    return torch.cat([b.reshape(-1, 2).to(lead) for b in bufs], dim=0)


def lsh_self_join(index: SignatureIndex, *, d: int | None = None,
                  max_pairs: int = 1 << 16,
                  max_grow: int = 1 << 24,
                  n_shards: int | None = None,
                  devices=None,
                  prefilter: JoinPrefilter | None = None,
                  join_impl: str = "spgemm") -> SelfJoinResult:
    """All-pairs candidate generation over the indexed corpus.

    Emits every within-bucket pair of every band, deduplicates across
    bands and shards, and (``d=``) exact-filters by packed Hamming
    distance. ``n_shards`` (default: the index's own) routes emission
    through the bucket partition, one shard on each of ``devices``
    (default: the index's device); the result arrays are the same for
    every ``n_shards``. The output is sized at the exact emission total,
    so nothing grows or retries; true demand (the largest per-(shard,
    band) pair total, in int64) beyond ``max_grow`` raises — never a
    silent cap. ``prefilter=`` fuses the ungapped X-drop prefilter into
    the join (:class:`JoinPrefilter`).
    """
    _check_impl(join_impl)
    n = int(n_shards) if n_shards is not None else index.n_shards
    devs, groups = _resolve_devices(index, n, devices)
    part = index.partition(n)
    need = int(part.pair_totals.max()) if part.pair_totals.size else 0
    if need > max_grow:
        _grow_overflow("self-join", max_grow)
    if need == 0:       # every bucket is a singleton: no collisions at all
        return _empty(index.size)
    caps = _shard_caps(part)
    live = caps[caps > 0]
    uniform = int(live.min()) == int(live.max())
    total = int(part.pair_totals.sum())
    # the reference's ceiling: it only raises when the deduplicated union
    # must grow past max_grow
    limit = max(max_pairs, int(caps.max()), max_grow)
    lead = devs[0]
    with span("emission", cat="allpairs", shards=n, impl=join_impl,
              devices=len(groups), uniform=uniform, need=need):
        if uniform and len(groups) == 1:
            # one fused program: products + dedup + filter + compaction
            _, offs_s, ids_s = (a.to(lead) for a in part.device_slabs())
            offs_f = offs_s.reshape(-1, offs_s.shape[-1])
            ids_f = ids_s.reshape(-1, ids_s.shape[-1])
            sigs = index.device_sigs.to(lead)
            out_cap = next_pow2(max(1, min(total, limit)))
            if index.layout == "band" and index.size <= PACKED_KEY_MAX_ID:
                # band layout: a pair repeats only across bands, and the
                # band keys spot the repeats at emission
                band_f = torch.arange(offs_s.shape[1]).repeat(
                    offs_s.shape[0])
                pairs, count = spgemm_join_self_keys(
                    offs_f, ids_f, band_f, index.device_band_keys.to(lead),
                    sigs, cap=int(caps.max()), out_cap=out_cap, d=d)
            else:
                pairs, count = spgemm_join_self(
                    offs_f, ids_f, sigs, cap=int(caps.max()),
                    out_cap=out_cap, d=d)
            n_cand = int(count)
            if n_cand > limit:
                _grow_overflow("self-join", max_grow)
            return _finish_pairs(pairs, n_cand, index, prefilter)
        # several devices, or skewed demand: per-device (uniform) or
        # per-shard (skewed) emission, merged on the lead device
        _, offs_np, ids_np = part.host_slabs()
        bufs = []
        if uniform:
            cap = int(caps.max())
            for dev, members in groups:
                offs = torch.from_numpy(
                    offs_np[members].astype(np.int64)).to(dev)
                ids = torch.from_numpy(ids_np[members]).to(dev)
                bufs.append(spgemm_self_slab(_flat(offs), _flat(ids),
                                             cap=cap))
        else:
            for s in range(n):
                if caps[s] == 0:
                    continue            # this shard's buckets are singletons
                offs = torch.from_numpy(
                    offs_np[s].astype(np.int64)).to(devs[s])
                ids = torch.from_numpy(ids_np[s]).to(devs[s])
                bufs.append(spgemm_self_slab(offs, ids, cap=int(caps[s])))
        cand = _merge(bufs, lead)
    return _pack_exact(cand, index, d, total, limit, max_grow, "self-join",
                       prefilter)


def _segment_stack(seg, n_shards: int, device: torch.device):
    """One sealed segment's delta-join arrays, cached on the segment
    (sealed = immutable): its :class:`BucketPartition` per shard count
    (exact per-(shard, band) pair totals) and, per (shard count, device),
    its pow2-padded shard-stacked slabs there — keys int64 holding uint32,
    offsets int64, ids int32, each (n_shards, nb, X)."""
    cache = getattr(seg, "_join_stacks", None)
    if cache is None:
        cache = seg._join_stacks = {}
    part = cache.get(n_shards)
    if part is None:
        part = cache[n_shards] = BucketPartition(seg.csr, n_shards)
    slabs = cache.get((n_shards, device))
    if slabs is None:
        keys_s, offs_s, ids_s = pad_slabs_pow2(*part.host_slabs())
        slabs = cache[(n_shards, device)] = (
            torch.from_numpy(keys_s.astype(np.int64)).to(device),
            torch.from_numpy(offs_s.astype(np.int64)).to(device),
            torch.from_numpy(ids_s).to(device))
    return part, slabs


def _cross_totals(dpart: BucketPartition, rpart: BucketPartition
                  ) -> np.ndarray:
    """Exact int64 cross-pair totals per (shard, band) between a delta
    partition's buckets and a resident partition's matching buckets.
    Ownership is keyed on the bucket key, so matching buckets land on the
    same shard of both partitions."""
    out = np.zeros((dpart.n_shards, dpart.n_bands), np.int64)
    for s in range(dpart.n_shards):
        for b in range(dpart.n_bands):
            dk, do, _ = dpart.shards[s][b]
            rk, ro, _ = rpart.shards[s][b]
            if len(dk) == 0 or len(rk) == 0:
                continue
            dn = np.diff(do).astype(np.int64)
            pos = np.searchsorted(rk, dk)
            pos_c = np.clip(pos, 0, len(rk) - 1)
            match = (pos < len(rk)) & (rk[pos_c] == dk)
            rn = np.where(match,
                          (np.asarray(ro)[pos_c + 1] - np.asarray(ro)[pos_c]
                           ).astype(np.int64), 0)
            out[s, b] = int((dn * rn).sum())
    return out


def _flat(a: torch.Tensor) -> torch.Tensor:
    """(S, nb, X) slab -> (S*nb, X) for the band-stacked products."""
    return a.reshape(-1, a.shape[-1])


def lsh_delta_join(index: SignatureIndex, *, base_size: int,
                   d: int | None = None,
                   max_pairs: int = 1 << 16,
                   max_grow: int = 1 << 24,
                   n_shards: int | None = None,
                   devices=None,
                   prefilter: JoinPrefilter | None = None,
                   join_impl: str = "spgemm") -> SelfJoinResult:
    """Incremental self-join: only the pairs touching rows >= ``base_size``
    (a segment boundary). For each new segment, its within-bucket pairs
    (upper mask, K5 on CUDA) and its cross pairs against the matching
    buckets of every earlier segment; resident-vs-resident pairs are never
    re-enumerated. Both masks run per shard under the segments' bucket
    partitions, the shards sharing a device in one launch there
    (``devices``: one per shard, default the index's device). The result
    unions with the pre-ingest pair set to exactly :func:`lsh_self_join`
    over the grown corpus, for every ``n_shards``."""
    _check_impl(join_impl)
    n = int(n_shards) if n_shards is not None else index.n_shards
    devs, groups = _resolve_devices(index, n, devices)
    index.seal()
    segs = index.segments
    boundaries = [s.base for s in segs] + [index.size]
    if base_size not in boundaries:
        raise ValueError(
            f"base_size {base_size} is not a segment boundary "
            f"{boundaries}; delta joins ingest whole segments")
    if base_size == index.size:     # nothing new
        return _empty(index.size)
    k = boundaries.index(base_size)

    def part(i) -> BucketPartition:
        return _segment_stack(segs[i], n, devs[0])[0]

    def slabs(i, dev, members):
        """Segment i's slabs of the shards ``members``, on ``dev``."""
        stack = _segment_stack(segs[i], n, dev)[1]
        if len(members) == n:
            return stack
        sel = torch.tensor(members, device=dev)
        return tuple(a.index_select(0, sel) for a in stack)

    bufs = []
    total = 0
    with span("delta_emission", cat="allpairs", shards=n, impl=join_impl,
              devices=len(groups), new_segments=len(segs) - k,
              resident_segments=k):
        for s in range(k, len(segs)):
            within = part(s).pair_totals
            need_w = int(within.max(initial=0))
            if need_w > max_grow:
                _grow_overflow("delta join", max_grow)
            if need_w > 0:
                total += int(within.sum())
                for dev, members in groups:
                    _, offs_s, ids_s = slabs(s, dev, members)
                    bufs.append(spgemm_self_slab(
                        _flat(offs_s), _flat(ids_s), cap=next_pow2(need_w)))
            for r in range(s):      # every earlier segment is resident
                totals = _cross_totals(part(s), part(r))
                need_c = int(totals.max(initial=0))
                if need_c > max_grow:
                    _grow_overflow("delta join", max_grow)
                if need_c == 0:
                    continue
                total += int(totals.sum())
                for dev, members in groups:
                    bufs.append(spgemm_cross_slab(
                        *(_flat(a) for a in (*slabs(s, dev, members),
                                             *slabs(r, dev, members))),
                        cap=next_pow2(need_c)))
        if not bufs:
            return _empty(index.size)
        cand = _merge(bufs, devs[0])
    return _pack_exact(cand, index, d, total, max(max_pairs, max_grow),
                       max_grow, "delta join", prefilter)


def brute_force_collisions(index: SignatureIndex) -> set[tuple[int, int]]:
    """Oracle: enumerate all within-bucket pairs with host loops (small
    corpora only)."""
    index._ensure_built()
    out: set[tuple[int, int]] = set()
    for (keys, offsets, ids) in index._csr_np:
        ids = np.asarray(ids)
        offsets = np.asarray(offsets)
        for u in range(len(keys)):
            members = ids[offsets[u]:offsets[u + 1]]
            for a in range(len(members)):
                for b in range(a + 1, len(members)):
                    i, j = int(members[a]), int(members[b])
                    out.add((min(i, j), max(i, j)))
    return out
