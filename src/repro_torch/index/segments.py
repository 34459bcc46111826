"""Append-only index segments — the unit of incremental growth.

Every ingest seals a **segment**: its own packed signature rows plus its
own per-band CSR buckets over *global* ids. The merged bucket table of the
whole index is a stable linear merge of the segment CSRs
(:func:`merge_band_csrs`), bit-exact with a from-scratch build.

As in the reference (``repro/index/segments.py``), the CSR arrays are host
numpy: keys uint32, offsets int32, ids int32. Only the keys of a new
segment (band keys, or flip keys) are computed with torch, on the index's
device. Manifest persistence is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.join import band_keys, flip_masks
from ..util import as_unsigned, u32_to_i32


@dataclasses.dataclass
class Segment:
    """One sealed, immutable slice of the index. ``base`` is the global id
    of row 0; ``csr`` holds one ``(keys, offsets, ids)`` sorted bucket
    table per band with **global** ids."""
    base: int
    sigs: np.ndarray                    # (n, f//32) uint32
    valid: np.ndarray                   # (n,) bool
    csr: list                           # per band: (keys, offsets, ids)


def sort_bucket(keys: np.ndarray, ids: np.ndarray):
    """Group (key, id) entries into CSR: (unique keys, offsets, sorted ids).

    ``keys`` are unsigned 32-bit values (uint32, or int64 holding them), so
    numpy sorts them in uint32 order. The stable sort keeps every bucket's
    members in ascending id order — the bit-exactness anchor of the merge.
    """
    order = np.argsort(keys, kind="stable")
    ks, sids = keys[order], ids[order]
    uk, first = np.unique(ks, return_index=True)
    offsets = np.concatenate([first, [len(ks)]]).astype(np.int32)
    return uk.astype(np.uint32), offsets, sids.astype(np.int32)


def _empty_csr():
    return sort_bucket(np.zeros(0, np.uint32), np.zeros(0, np.int32))


def build_segment(sigs, valid, base: int, *, layout: str, f: int, d: int,
                  bands: int, interleave: bool, key_hash: str,
                  device=torch.device("cpu")) -> Segment:
    """Seal a segment: bucket its rows under the index's layout — per-band
    CSRs of band keys, or one CSR of every row's C(f, <=d) flip keys.
    Keys are computed on ``device``; the CSR is built on the host."""
    sigs = np.ascontiguousarray(np.asarray(sigs, np.uint32))
    valid = np.asarray(valid, bool).reshape(-1)
    local_ids = np.nonzero(valid)[0].astype(np.int64)
    gids = (local_ids + base).astype(np.int32)
    if layout == "flip":
        if len(gids) == 0:
            return Segment(base, sigs, valid, [_empty_csr()])
        masks = flip_masks(f, d)[:, 0].astype(np.int64)
        w0 = as_unsigned(u32_to_i32(sigs[local_ids, 0]).to(device))
        keys = (w0[:, None] ^ torch.from_numpy(masks).to(device)[None, :])
        ids = np.repeat(gids, masks.shape[0])
        return Segment(base, sigs, valid,
                       [sort_bucket(keys.reshape(-1).cpu().numpy(), ids)])
    if len(gids) == 0:
        return Segment(base, sigs, valid,
                       [_empty_csr() for _ in range(bands)])
    kb = band_keys(u32_to_i32(sigs[local_ids]).to(device), f, bands,
                   interleave=interleave, key_hash=key_hash).cpu().numpy()
    return Segment(base, sigs, valid,
                   [sort_bucket(kb[:, b], gids) for b in range(bands)])


def merge_band_csrs(csr_lists: list[list]) -> list:
    """Merge per-segment per-band CSRs into one bucket table per band.
    Segments arrive in base order with disjoint ascending id ranges, so the
    stable sort groups equal keys with ids ascending — exactly the table of
    a from-scratch build over the concatenated corpus."""
    if len(csr_lists) == 1:
        return csr_lists[0]
    out = []
    for b in range(len(csr_lists[0])):
        keys = np.concatenate(
            [np.repeat(c[b][0], np.diff(c[b][1])) for c in csr_lists])
        ids = np.concatenate([c[b][2] for c in csr_lists])
        out.append(sort_bucket(keys, ids))
    return out
