"""Bucket-sharded probe serving: shards own buckets, query blocks rotate.

The port of ``repro/index/shard.py``. Each shard owns the buckets that
:func:`repro_torch.index.partition.bucket_owners` routes to it
(``mix32(band_key) % n_shards`` — the MapReduce shuffle), held as a
self-contained stacked-padded CSR slab *with its bucket entries'
signature rows*, so no shard needs the whole (N, nw) signature matrix.

Placement: ``devices`` names one torch device per shard, repeats allowed.
On one card, ``--shards N`` puts all N shards on it: shards are then a
data layout. Slabs of the shards that share a device are stacked on a
leading shard axis there.

The query batch is split into per-shard blocks that go round the shards
in a **two-phase** ring, the reference's ``ppermute`` ring as plain
tensor code (one process, no ``torch.distributed``):

* **phase 1 — collect**: the blocks a device holds probe every shard
  resident there in one batched call (searchsorted on the CSR keys of
  the stacked slabs, then a gather of the owning shard's matched entries'
  ids and signature rows). A (band, key) bucket is owned by exactly one
  shard, so each (query, band) slot has at most one owner. The carried
  (keys, ids, signatures) then move to the next device with ``.to()``;
  after one hop per device they are home. On one card — shards as a data
  layout — that is one collect and no move at all.
* **phase 2 — score at home**: each block's home device runs ONE Hamming
  pass over its collected candidates (the SWAR popcount of
  ``core/hamming.py``), then the shared ``_dedup_candidates`` (distance,
  id) tie-break and top-k of ``topk_probe``.

Growth is a **delta refresh**: segments sealed after the base placement
partition on their own (bucket owners never change) and ride along as a
second, small delta slab per shard. Each hop probes base + delta and sums
the matched-bucket sizes, so the grow-and-retry overflow contract sees
the true size of a bucket split across the two. When the delta outgrows
the base, or after ``index.compact()``, the base is re-placed;
:meth:`ShardedIndex.compact` folds the delta in on demand.

Exactness: buckets are never split across shards, so the union of the
shards' collections is the single-device candidate set, and the home pass
is ``topk_probe``'s filter. Results are bit-exact with
:func:`repro_torch.index.service.topk_probe` for every ``n_shards`` —
ids, distances, tie-breaks, the final cap and ``truncated`` (the overflow
max is taken over every (shard, hop) probe). A call serves the slabs it
found when it started: a refresh on another thread swaps them for the
next call, never in the middle of a ring.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..core.hamming import hamming_distance
from ..obs import span
from ..obs.trace import record as record_span
from ..util import resolve_device, u32_to_i32
from .partition import pad_slabs_pow2
from .service import _dedup_candidates, _finalize_topk
from .spgemm import match_buckets
from .store import SignatureIndex


def _collect(qk, slab, *, cap: int):
    """Phase-1 collection on the stacked slabs of the shards resident on
    one device: qk (Q, nb) int64 keys of the queries the device holds;
    slab keys (S, nb, U), offsets (S, nb, U+1), ids (S, nb, E), entry
    signatures (S, nb, E, nw) -> cand (nb, Q, cap) int32 (-1 where
    unmatched), sig (nb, Q, cap, nw), size (nb, Q) int32 — the true
    matched-bucket sizes. Each (band, query) bucket lives in at most one
    of the S shards, the one with a nonzero size; its members are taken
    from there. No distance work: that happens once, at home."""
    keys, offs, ids, esig = slab
    S, nb, E = ids.shape
    start, end = match_buckets(qk.T.expand(S, nb, -1).contiguous(), keys,
                               offs)
    size = end - start                              # (S, nb, Q), 0 off-owner
    own = size.argmax(0, keepdim=True)              # (1, nb, Q)
    start, size = start.gather(0, own)[0], size.gather(0, own)[0]
    band = torch.arange(nb, device=qk.device)[:, None]
    slot = torch.arange(cap, device=qk.device)
    # flat (shard, band, entry) positions; those past the bucket are masked
    flat = ((own[0] * nb + band) * E + start)[..., None] + slot
    flat = flat.clamp_(max=ids.numel() - 1)
    ok = slot < size[..., None]
    cand = torch.where(ok, ids.reshape(-1)[flat], -1)
    sig = torch.where(ok[..., None], esig.reshape(-1, esig.shape[-1])[flat],
                      0)
    return cand, sig, size.to(torch.int32)


class ShardedIndex:
    """A :class:`SignatureIndex` whose *buckets* are laid out over shards,
    one per entry of ``devices`` (default: one shard on the index's
    device)."""

    def __init__(self, index: SignatureIndex, devices=None):
        self.index = index
        devs = [index.device] if devices is None else list(devices)
        if not devs:
            raise ValueError("devices must name at least one device")
        self.devices = tuple(resolve_device(d) for d in devs)
        self.n_shards = len(self.devices)
        # shards grouped by device, in order of first appearance: each
        # group's slabs and carried buffers stack on a leading shard axis
        groups: dict[torch.device, list[int]] = {}
        for s, d in enumerate(self.devices):
            groups.setdefault(d, []).append(s)
        self._groups = [(d, tuple(m)) for d, m in groups.items()]
        # Serializes this replica's slab swaps AND the backing index's lazy
        # lifecycle mutations (seal/merge/partition) that refresh triggers.
        # Reentrant: refresh() takes it and also runs under it from
        # _refresh_if_stale. A replica fleet (repro_torch.serve.fleet)
        # installs ONE lock shared by every replica and its ingest thread.
        self.refresh_lock = threading.RLock()
        self._place()

    # ------------------------------------------------------------ placement
    def _put(self, part):
        """Upload a partition's slabs, padded to powers of two on the
        bucket and entry axes (``pad_slabs_pow2``), one stack per device:
        keys and offsets int64 (keys hold the uint32 values), ids int32,
        entry signatures int32 bit patterns. Returns (per-group slabs,
        padded bucket count)."""
        keys, offs, ids = part.host_slabs()
        keys, offs, ids, esig = pad_slabs_pow2(keys, offs, ids,
                                               part.host_entry_sigs())
        slabs = []
        for dev, members in self._groups:
            sel = list(members)
            slabs.append((
                torch.from_numpy(keys[sel].astype(np.int64)).to(dev),
                torch.from_numpy(offs[sel].astype(np.int64)).to(dev),
                torch.from_numpy(ids[sel]).to(dev),
                u32_to_i32(esig[sel]).to(dev)))
        return slabs, keys.shape[2]

    def _place(self) -> None:
        """Full (re)placement: every segment merged into the base slabs.
        Paid at construction, after ``index.compact()`` and when the delta
        outgrows the base — never on a routine refresh."""
        index = self.index
        index.seal()
        with span("place", cat="lifecycle", shards=self.n_shards,
                  epoch=index.epoch):
            part = index.partition(self.n_shards)
            self._slabs, self._n_base = self._put(part)
        self._part = part
        self._delta = None          # per-group slabs of segments past base
        self._n_delta = 0
        self._gen = index.generation
        self._base_epoch = index.epoch
        self._delta_epoch = index.epoch

    def refresh(self) -> None:
        """Ingest segment deltas without a full reload.

        Bucket owners never change (``mix32(key) % n_shards`` is id-free),
        so segments sealed since the base placement partition on their own
        and ride along as per-shard delta slabs; upload cost is O(delta).
        Falls back to a full re-place when the index was compacted
        (generation bump), the base is empty, or the delta has outgrown
        the base.
        """
        with self.refresh_lock:
            index = self.index
            index.seal()
            if index.generation != self._gen:
                self._place()       # compaction collapsed our base segments
                return
            if index.epoch == self._delta_epoch:
                return              # nothing new
            if self._n_base == 0:   # empty base: just re-place
                self._place()
                return
            dpart = index.delta_partition(self.n_shards, self._base_epoch)
            if int(dpart.n_entries.sum()) >= int(self._part.n_entries.sum()):
                self._place()       # delta outgrew base: compact placement
                return
            if int(dpart.n_buckets.sum()) == 0:  # only invalid rows arrived
                self._delta_epoch = index.epoch
                return
            with span("refresh", cat="lifecycle",
                      from_epoch=self._delta_epoch, to_epoch=index.epoch,
                      entries=int(dpart.n_entries.sum())):
                self._delta = None  # drop the old delta before realloc
                self._delta, self._n_delta = self._put(dpart)
            self._delta_epoch = index.epoch

    def compact(self) -> None:
        """Fold the delta slabs back into one base placement (serving-side
        compaction; probe results are identical before and after)."""
        with self.refresh_lock:
            with span("compact_serving", cat="lifecycle",
                      epoch=self.index.epoch):
                self._place()

    def _refresh_if_stale(self) -> None:
        with self.refresh_lock:
            if (self.index.generation, self.index.epoch) != \
                    (self._gen, self._delta_epoch):
                self.refresh()

    @property
    def size(self) -> int:
        return self.index.size

    @property
    def epoch(self) -> tuple[int, int]:
        """(base_epoch, delta_epoch) segment counters this replica serves."""
        return (self._base_epoch, self._delta_epoch)

    # ------------------------------------------------------------ ring
    def _ring(self, slabs, delta, qk_p, qs_p, *, Bl: int, cap: int, k: int):
        """Both phases of the ring over the padded blocks, against the
        per-group ``slabs`` and ``delta`` (or None): qk_p (n*Bl, nb) int64,
        qs_p (n*Bl, nw) int32 -> (ids (n*Bl, k), dists (n*Bl, k)) int32
        numpy and the largest matched-bucket size any probe saw."""
        n, G = self.n_shards, len(self._groups)
        nb, nw = qk_p.shape[1], qs_p.shape[1]
        C = nb * cap * (1 if delta is None else 2)
        # each group's home rows: the blocks of the shards it holds
        rows = [slice(None)] if G == 1 else [
            np.concatenate([np.arange(s * Bl, (s + 1) * Bl) for s in m])
            for _, m in self._groups]
        carried = [(qk_p[r].to(dev), None, None)
                   for r, (dev, _) in zip(rows, self._groups)]
        msz = []
        for _ in range(G):
            for g in range(G):
                qk, idb, sgb = carried[g]
                cand, sig, size = _collect(qk, slabs[g], cap=cap)
                if delta is not None:
                    c2, s2, z2 = _collect(qk, delta[g], cap=cap)
                    # a bucket split across base and delta is ONE bucket of
                    # the merged table: candidates union, true size is the
                    # sum
                    cand = torch.cat([cand, c2], dim=2)
                    sig = torch.cat([sig, s2], dim=2)
                    size = size + z2
                # (nb, Q, cap') -> (Q, nb*cap'), the fused-probe layout
                Q = qk.shape[0]
                cand = cand.transpose(0, 1).reshape(Q, C)
                sig = sig.transpose(0, 1).reshape(Q, C, nw)
                if idb is not None:
                    # each slot is written on one hop only: where() is a
                    # union
                    ok = cand >= 0
                    cand = torch.where(ok, cand, idb)
                    sig = torch.where(ok[..., None], sig, sgb)
                carried[g] = (qk, cand, sig)
                msz.append(size.max())
            if G > 1:   # every group's blocks move one device on
                carried = [tuple(x.to(dev) for x in carried[(g - 1) % G])
                           for g, (dev, _) in enumerate(self._groups)]
        # phase 2: one Hamming pass over each block's candidates at home,
        # then topk_probe's dedup + top-k tail
        nid = np.empty((n * Bl, k), np.int32)
        nd = np.empty((n * Bl, k), np.int32)
        for r, (dev, _), (_, idb, sgb) in zip(rows, self._groups, carried):
            qs = qs_p[r].to(dev)
            dist = hamming_distance(qs[:, None, :], sgb)
            cs, dvals = _dedup_candidates(idb, dist, idb >= 0)
            nid[r], nd[r] = torch.stack(
                _finalize_topk(dvals, cs, k)).cpu().numpy()
        top = max(int(x) for x in msz)
        return nid, nd, top

    def topk(self, q_sigs, *, k: int, cap: int = 32, max_cap: int = 1 << 14):
        """Global top-k via shard-local bucket probes.

        (B, nw) query signatures (int32 bit-pattern tensor or uint32 numpy)
        -> (ids (B, k), dists (B, k) int32 numpy, -1 padded, final_cap,
        truncated) — bit-exact with
        :func:`~repro_torch.index.service.topk_probe` (same candidates,
        same tie-breaks, same grow-and-retry overflow contract), whether
        the placement is one base slab or base + delta.
        """
        with self.refresh_lock:     # one placement for the whole call
            self._refresh_if_stale()
            slabs, delta = self._slabs, self._delta
            n_entries = self._n_base + self._n_delta
        q = q_sigs if torch.is_tensor(q_sigs) else u32_to_i32(q_sigs)
        q = q.to(self.index.device)
        B = q.shape[0]
        n = self.n_shards
        if B == 0 or n_entries == 0:
            return (np.full((B, k), -1, np.int32),
                    np.full((B, k), -1, np.int32), cap, False)
        qk = self.index.query_keys(q).T                 # (B, nb) int64
        Bl = max(-(-B // n), 1)
        # padding rows replicate query 0: real keys, so they can only
        # re-match buckets query 0 already probed — the overflow max and
        # the (cap, truncated) contract stay bit-exact with topk_probe
        # (all-zero padding keys could match a real key-0 bucket that no
        # actual query probes)
        pad = Bl * n - B
        qk_p = torch.cat([qk, qk[:1].expand(pad, -1)])
        qs_p = torch.cat([q, q[:1].expand(pad, -1)])
        t_ring = time.perf_counter()
        while True:
            nid, nd, top = self._ring(slabs, delta, qk_p, qs_p, Bl=Bl,
                                      cap=cap, k=k)
            truncated = top > cap
            if not truncated or cap >= max_cap:
                break
            cap = min(cap * 2, max_cap)     # grow-and-retry
        record_span("ring_probe", t_ring, time.perf_counter(), B=B,
                    shards=n, cap=cap, truncated=truncated,
                    delta=delta is not None)
        return nid[:B], nd[:B], cap, truncated

