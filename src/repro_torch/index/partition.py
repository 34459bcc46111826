"""Shard-owned CSR bucket partition — the MapReduce shuffle as a data layout.

Every (band, key) bucket is owned by shard ``mix32(key) % n_shards``, and
each shard gets a self-contained stacked-padded CSR slab, the layout the
fused probe runs against (``repro/index/partition.py``), with its bucket
entries' signature rows when the index passes its signatures. The
single-device probe is shard 0 of the 1-way partition; the sharded
serving ring (:class:`repro_torch.index.shard.ShardedIndex`) probes
every shard's slab.

Padding follows the probe's inertness rules: keys pad by repeating the
last key (sorted order kept; a search finds the first occurrence), offsets
by repeating the end offset (padded slots are empty buckets).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.join import mix32
from ..util import next_pow2


def pad_slabs_pow2(keys, offs, ids, esig=None):
    """Pad stacked CSR slabs' bucket (U) and entry (E) axes to powers of
    two, on the trailing axes, under the inertness rules above (ids — and
    entry-signature rows (..., E, nw) when given — pad with zeros, which no
    empty bucket ever reaches)."""
    U, E = keys.shape[-1], ids.shape[-1]
    Uq, Eq = next_pow2(max(U, 1)), next_pow2(max(E, 1))
    if Uq > U:
        keys = np.concatenate(
            [keys, np.repeat(keys[..., -1:], Uq - U, axis=-1)], axis=-1)
        offs = np.concatenate(
            [offs, np.repeat(offs[..., -1:], Uq - U, axis=-1)], axis=-1)
    if Eq > E:
        ids = np.concatenate(
            [ids, np.zeros(ids.shape[:-1] + (Eq - E,), ids.dtype)], axis=-1)
        if esig is not None:
            pad = np.zeros(esig.shape[:-2] + (Eq - E, esig.shape[-1]),
                           esig.dtype)
            esig = np.concatenate([esig, pad], axis=-2)
    return (keys, offs, ids) if esig is None else (keys, offs, ids, esig)


def bucket_owners(keys, n_shards: int) -> np.ndarray:
    """Owning shard of each bucket key: ``mix32(key) % n_shards`` (int32)."""
    mixed = mix32(torch.from_numpy(np.asarray(keys, np.uint32).astype(
        np.int64))).numpy()
    return (mixed % max(n_shards, 1)).astype(np.int32)


def _take_buckets(keys, offsets, ids, sel):
    """Sub-CSR of the buckets at (ascending) positions ``sel``."""
    keys = np.asarray(keys)
    offsets = np.asarray(offsets).astype(np.int64)
    ids = np.asarray(ids)
    sizes = (offsets[1:] - offsets[:-1])[sel]
    sub_offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    total = int(sizes.sum())
    if total == 0:
        return (keys[sel].astype(np.uint32), sub_offsets,
                np.zeros(0, np.int32))
    start = np.repeat(offsets[sel], sizes)
    base = np.repeat(sub_offsets[:-1].astype(np.int64), sizes)
    idx = start + (np.arange(total, dtype=np.int64) - base)
    return (keys[sel].astype(np.uint32), sub_offsets,
            ids[idx].astype(np.int32))


def _pair_total(offsets) -> int:
    """Within-bucket pairs of one CSR: sum of m*(m-1)/2, in int64."""
    m = np.diff(np.asarray(offsets)).astype(np.int64)
    return int((m * (m - 1) // 2).sum())


class BucketPartition:
    """``n_shards`` shard-owned slabs over per-band CSR bucket tables:
    per-shard host CSRs (``shards[s][b]``), the exact within-bucket pair
    total of each (shard, band) in int64 (``pair_totals``, what the
    self-join sizes its buffers from: it must never wrap) and the stacked
    padded slabs, uploaded to ``device`` once on first use. With the
    index's packed signatures ``sigs`` (N, nw) uint32, each slab also
    carries its entries' signature rows (:meth:`host_entry_sigs`), so a
    shard's probe never needs the whole (N, nw) matrix."""

    def __init__(self, csr_per_band, n_shards: int, sigs=None, *,
                 device=torch.device("cpu")):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.n_bands = len(csr_per_band)
        self.device = torch.device(device)
        self._sigs = None if sigs is None else np.asarray(sigs, np.uint32)
        owners = [bucket_owners(keys, self.n_shards)
                  for keys, _, _ in csr_per_band]
        self.shards = [
            [_take_buckets(keys, offsets, ids, np.flatnonzero(owners[b] == s))
             for b, (keys, offsets, ids) in enumerate(csr_per_band)]
            for s in range(self.n_shards)]
        self.pair_totals = np.array(
            [[_pair_total(offsets) for _, offsets, _ in per]
             for per in self.shards], np.int64).reshape(self.n_shards,
                                                        self.n_bands)
        self._stacked = self._stack()
        self._dev = None
        self._esig_np = None

    def _stack(self):
        """keys (S, nb, U) uint32, offsets (S, nb, U+1) int32,
        ids (S, nb, max(E, 1)) int32, every (shard, band) padded."""
        S, nb = self.n_shards, self.n_bands
        U = max((len(k) for per in self.shards for k, _, _ in per), default=0)
        E = max((len(i) for per in self.shards for _, _, i in per), default=0)
        keys_s = np.zeros((S, nb, U), np.uint32)
        offs_s = np.zeros((S, nb, U + 1), np.int32)
        ids_s = np.zeros((S, nb, max(E, 1)), np.int32)
        for s, per_band in enumerate(self.shards):
            for b, (keys, offsets, ids) in enumerate(per_band):
                u, e = len(keys), len(ids)
                keys_s[s, b, :u] = keys
                if u:
                    keys_s[s, b, u:] = keys[-1]
                offs_s[s, b, :u + 1] = offsets
                offs_s[s, b, u + 1:] = offsets[u] if u else 0
                ids_s[s, b, :e] = ids
        return keys_s, offs_s, ids_s

    @property
    def n_buckets(self) -> np.ndarray:
        """(S,) bucket count owned by each shard (load-balance diagnostic)."""
        return np.array([sum(len(k) for k, _, _ in per)
                         for per in self.shards], np.int64)

    @property
    def n_entries(self) -> np.ndarray:
        """(S,) bucket-entry count owned by each shard."""
        return np.array([sum(len(i) for _, _, i in per)
                         for per in self.shards], np.int64)

    def host_slabs(self):
        """The stacked numpy slabs (keys, offsets, ids)."""
        return self._stacked

    def host_entry_sigs(self) -> np.ndarray:
        """Per-entry signature rows aligned with the ids slab: (S, nb, E,
        nw) uint32 numpy. Padded and empty slots hold id 0's row, which the
        probe's mask discards. Built lazily: only the serving ring pays."""
        if self._sigs is None:
            raise ValueError("partition built without sigs; entry "
                             "signatures unavailable")
        if self._esig_np is None:
            ids_s = self._stacked[2]
            if self._sigs.shape[0] == 0:    # empty index: all-pad slots
                self._esig_np = np.zeros(ids_s.shape + (self._sigs.shape[1],),
                                         np.uint32)
            else:
                self._esig_np = self._sigs[ids_s]
        return self._esig_np

    def device_slabs(self):
        """The stacked slabs on the device (uploaded once): keys as int64
        holding the uint32 values, offsets int64, ids int32."""
        if self._dev is None:
            keys_s, offs_s, ids_s = self._stacked
            self._dev = (
                torch.from_numpy(keys_s.astype(np.int64)).to(self.device),
                torch.from_numpy(offs_s.astype(np.int64)).to(self.device),
                torch.from_numpy(ids_s).to(self.device))
        return self._dev

    def probe_arrays(self, shard: int):
        """Shard ``shard``'s slab as the (nb, ...) arrays the probe takes."""
        keys_s, offs_s, ids_s = self.device_slabs()
        return keys_s[shard], offs_s[shard], ids_s[shard]
