"""Signature joins — finding (query, reference) pairs within Hamming d.

The joins of ``repro/core/join.py`` on torch (the dense join is
``core/hamming.py::threshold_pairs``):

* ``flip_join`` — the paper's Algorithms 3+4: every reference emits all
  C(f, <=d) bit-flips of itself as keys, queries emit their own signature,
  equal keys collide (a sort plus two searchsorted). Exact, no duplicates.
  f <= 32.
* ``band_join`` — pigeonhole banding: split the f bits into
  ``bands >= d+1`` disjoint groups; any pair within d agrees exactly on at
  least one band. Per-band equality joins, dedup, exact popcount filter.

Every join returns a fixed-capacity pair buffer (rows past the true count
are -1) and the true count, so callers can detect overflow and grow.

Keys are int64 tensors holding uint32 values: torch's uint32 has no shifts
and no ``searchsorted``, and an int32 view would reorder keys >= 2^31.
Sorts are stable, as ``jnp.argsort`` is, so equal keys keep ascending ids.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ..util import as_unsigned
from .hamming import hamming_distance
from .simhash import unpack_bits

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------- flip join
@functools.lru_cache(maxsize=8)
def flip_masks(f: int, d: int) -> np.ndarray:
    """All XOR masks with popcount <= d, packed: (M, f//32) uint32."""
    nw = f // 32
    masks = []
    for dd in range(d + 1):
        for comb in itertools.combinations(range(f), dd):
            m = np.zeros(nw, dtype=np.uint64)
            for b in comb:
                m[b // 32] |= np.uint64(1) << np.uint64(b % 32)
            masks.append(m.astype(np.uint32))
    return np.stack(masks, axis=0)


def _require_rows(name: str, q: torch.Tensor, r: torch.Tensor) -> None:
    """The reference's flip and band joins fail on an empty side (their
    clamped gathers have no row to read); the port refuses it plainly."""
    if q.shape[0] == 0 or r.shape[0] == 0:
        raise ValueError(f"{name} needs at least one query and one "
                         f"reference signature, got {q.shape[0]} x "
                         f"{r.shape[0]}")


def _emit_from_ranges(left, counts, sorted_ids, max_pairs: int):
    """Turn per-query ranges [left, left+counts) over ``sorted_ids`` into a
    fixed (max_pairs, 2) int32 (qid, rid) buffer. Returns (pairs, total),
    total a 0-d int64 tensor. Query ids are clamped to [0, Q-1] and range
    positions to [0, len(sorted_ids)-1] before each gather, as the
    reference clamps them; slots past the total become -1."""
    total = counts.sum()
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                          device=counts.device)
    offsets[1:] = torch.cumsum(counts, 0)
    slots = torch.arange(max_pairs, dtype=torch.int64, device=counts.device)
    qid = torch.searchsorted(offsets, slots, right=True) - 1
    qid = qid.clamp(0, counts.shape[0] - 1)
    j = slots - offsets[qid]
    valid = slots < total
    pos = (left[qid] + j).clamp(0, sorted_ids.shape[0] - 1)
    rid = sorted_ids[pos]
    pairs = torch.stack([torch.where(valid, qid, -1),
                         torch.where(valid, rid.to(torch.int64), -1)],
                        dim=-1).to(torch.int32)
    return pairs, total


def flip_join(q_sigs: torch.Tensor, r_sigs: torch.Tensor, *, f: int, d: int,
              max_pairs: int):
    """Paper-faithful flip join (f <= 32: keys are single 32-bit words).

    Returns (pairs (max_pairs, 3) int32 [qid, rid, dist], count — the true
    number of pairs, a 0-d int64 tensor). Each query's pairs come in
    ascending reference id: the stable sort keeps the expansion order
    ``rid * M + mask`` among equal keys.
    """
    if f > 32:
        raise ValueError("flip_join keys are single 32-bit words (f <= 32; "
                         "the paper used f=32)")
    _require_rows("flip_join", q_sigs, r_sigs)
    dev = r_sigs.device
    masks = torch.from_numpy(flip_masks(f, d)[:, 0].astype(np.int64)).to(dev)
    M = masks.shape[0]
    rk = (as_unsigned(r_sigs[:, 0])[:, None] ^ masks[None, :]).reshape(-1)
    rk_sorted, order = torch.sort(rk, stable=True)
    del rk
    rid_sorted = torch.div(order, M, rounding_mode="floor").to(torch.int32)
    del order
    qk = as_unsigned(q_sigs[:, 0])
    left = torch.searchsorted(rk_sorted, qk)
    right = torch.searchsorted(rk_sorted, qk, right=True)
    pairs2, count = _emit_from_ranges(left, right - left, rid_sorted,
                                      max_pairs)
    qv, rv = pairs2[:, 0], pairs2[:, 1]
    dist = hamming_distance(q_sigs[qv.clamp_min(0).long()],
                            r_sigs[rv.clamp_min(0).long()])
    dist = torch.where(qv >= 0, dist, -1).to(torch.int32)
    return torch.cat([pairs2, dist[:, None]], dim=-1), count


def band_bit_groups(f: int, bands: int, *, interleave: bool = False):
    """Disjoint partition of bit positions into ``bands`` groups:
    contiguous, or interleaved (bit i -> band i % bands). Both keep the
    pigeonhole guarantee; interleaving spreads position-skewed bit entropy."""
    if interleave:
        return [np.arange(b, f, bands) for b in range(bands)]
    edges = np.linspace(0, f, bands + 1).astype(int)
    return [np.arange(edges[b], edges[b + 1]) for b in range(bands)]


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` < 2^32 and a 32-bit constant ``c``,
    without overflowing int64: the high half-word's product only feeds
    bits 16..31, so it is masked to 16 bits before the shift."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def mix32(keys: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 over uint32 values held in int64; every product is
    reduced mod 2^32. A bijection on uint32, so bucket membership is
    exactly preserved."""
    h = keys.to(torch.int64) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def band_keys(sigs: torch.Tensor, f: int, bands: int, *,
              interleave: bool = False, key_hash: str = "none") -> torch.Tensor:
    """Per-band keys: (N, bands) int64 holding uint32 values.

    Bands up to 32 bits wide pack exactly into the key. Wider bands FOLD:
    the band's 32-bit words chain through :func:`mix32`
    (``acc = mix32(acc) ^ word``), so equal band bits always give equal
    keys. ``key_hash="splitmix"`` mixes each key once more (bijective).
    """
    if key_hash not in ("splitmix", "none"):
        raise ValueError(f"unknown key_hash {key_hash!r}")
    bits = unpack_bits(sigs, f).to(torch.int64)      # (N, f) in {0,1}
    keys = []
    for grp in band_bit_groups(f, bands, interleave=interleave):
        seg = bits[:, torch.as_tensor(grp, device=sigs.device)]
        acc = None
        for s0 in range(0, seg.shape[-1], 32):
            wordbits = seg[:, s0:s0 + 32]
            shifts = torch.arange(wordbits.shape[-1], device=sigs.device)
            word = torch.sum(wordbits << shifts, dim=-1)
            acc = word if acc is None else mix32(acc) ^ word
        keys.append(acc)
    out = torch.stack(keys, dim=-1)
    return mix32(out) if key_hash == "splitmix" else out


# largest id for which the packed int32 sort key c0*(B+1)+c1 stays exact:
# (B-1)*(B+1) + (B-1) = B^2 + B - 2 must fit int32
PACKED_KEY_MAX_ID = 46340
_I32_MAX = 2**31 - 1


def dedup_pairs(cand: torch.Tensor):
    """Sort a (M, 2) int32 candidate buffer lexicographically and mark the
    first copy of each valid (c0 >= 0) pair.

    torch's sort takes one key, so the pair sorts as the int64 key
    ``c0 << 32 | (c1 + 2^31)``, which orders exactly as (c0, c1) does.
    Returns (cand_sorted (M, 2) int32, keep (M,) bool)."""
    key = (cand[:, 0].to(torch.int64) << 32) + (cand[:, 1].to(torch.int64)
                                                + 2**31)
    ks = torch.sort(key).values
    cs = torch.stack([ks >> 32, (ks & 0xFFFFFFFF) - 2**31],
                     dim=-1).to(torch.int32)
    keep = torch.ones(ks.shape[0], dtype=torch.bool, device=cand.device)
    keep[1:] = ks[1:] != ks[:-1]
    return cs, keep & (cs[:, 0] >= 0)


def compact_pairs(cols, keep: torch.Tensor, max_pairs: int):
    """Stable-compact kept rows to the front of a fixed (max_pairs, k)
    buffer; rows where ``keep`` is False become -1.

    Returns (out (max_pairs, len(cols)) int32, count — the TRUE kept count,
    a 0-d int64 tensor, which exceeds max_pairs when the buffer
    truncated). Kept row i lands at ``sum(keep[:i])``; dropped and
    overflowing rows go to a discard slot past the buffer."""
    count = keep.sum()
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    dst = torch.where(keep & (pos < max_pairs), pos, max_pairs)
    rows = torch.stack([c.to(torch.int32) for c in cols], dim=-1)
    out = torch.full((max_pairs + 1, rows.shape[-1]), -1, dtype=torch.int32,
                     device=rows.device)
    out[dst] = rows
    return out[:max_pairs], count


def pack_unique_pairs(cand: torch.Tensor, *, out_cap: int, id_bound: int,
                      sigs: torch.Tensor | None = None, d: int | None = None):
    """Dedup + optional exact Hamming filter + front-compaction of a (M, 2)
    int32 candidate buffer — the shared pack tail of every join.

    Returns (pairs (out_cap, 2) int32 with -1 past the survivors, count —
    the TRUE survivor count, which exceeds ``out_cap`` when the buffer
    truncated; truncation keeps the canonically first survivors).

    With ``id_bound <= PACKED_KEY_MAX_ID`` (every id < bound) the tail runs
    as two sorts of the packed int32 key ``c0*(bound+1) + c1``: one makes
    duplicates adjacent, the second (dropped keys remapped to int32-max)
    is the compaction. Wider ids would alias keys, so they take
    :func:`dedup_pairs` + :func:`compact_pairs` — the same output.
    """
    if id_bound > PACKED_KEY_MAX_ID:
        cs, keep = dedup_pairs(cand)
        if d is not None:
            dist = hamming_distance(sigs[cs[:, 0].clamp_min(0).long()],
                                    sigs[cs[:, 1].clamp_min(0).long()])
            keep = keep & (dist <= d)
        return compact_pairs((cs[:, 0], cs[:, 1]), keep, out_cap)
    stride = id_bound + 1
    ks = torch.sort(cand[:, 0] * stride + cand[:, 1]).values
    keep = torch.ones(ks.shape[0], dtype=torch.bool, device=cand.device)
    keep[1:] = ks[1:] != ks[:-1]
    keep &= ks >= 0
    if d is not None:
        # invalid (negative) keys decode to ids outside [0, bound); they
        # are dropped by keep already, so any row in range stands in
        c0 = torch.div(ks, stride, rounding_mode="floor")
        c1 = ks - c0 * stride
        dist = hamming_distance(sigs[c0.clamp(0, id_bound - 1).long()],
                                sigs[c1.clamp(0, id_bound - 1).long()])
        keep &= dist <= d
    count = keep.sum()
    # the largest valid key is bound^2 + bound - 2 < int32-max for
    # bound <= 46340, so int32-max is a safe past-the-end sentinel
    ks2 = torch.sort(torch.where(keep, ks, _I32_MAX)).values
    M = ks2.shape[0]
    if out_cap <= M:
        ks2 = ks2[:out_cap]
    else:
        ks2 = torch.cat([ks2, torch.full((out_cap - M,), _I32_MAX,
                                         dtype=ks2.dtype,
                                         device=ks2.device)])
    o0 = torch.div(ks2, stride, rounding_mode="floor")
    pad = ks2 == _I32_MAX
    pairs = torch.stack([torch.where(pad, -1, o0),
                         torch.where(pad, -1, ks2 - o0 * stride)], dim=-1)
    return pairs.to(torch.int32), count


def band_join(q_sigs: torch.Tensor, r_sigs: torch.Tensor, *, f: int, d: int,
              max_pairs: int, bands: int | None = None):
    """Pigeonhole banding join: exact for bands >= d+1, no false negatives.

    Candidates colliding in several bands are deduplicated; all are
    exact-filtered by packed Hamming distance. Returns (pairs (max_pairs, 3)
    int32, count — 0-d int64, truncated — 0-d bool): ``truncated`` is True
    when a band's candidates overran the per-band capacity ``max_pairs``;
    the pair set and ``count`` itself (taken from the capacity-bounded
    candidates, as the reference takes it) may then be incomplete.
    """
    b = bands if bands is not None else d + 1
    if b < d + 1:
        raise ValueError("bands must be >= d+1 for an exact join")
    _require_rows("band_join", q_sigs, r_sigs)
    qk = band_keys(q_sigs, f, b).T.contiguous()      # (b, Q)
    rk = band_keys(r_sigs, f, b).T.contiguous()      # (b, R)
    cap = max_pairs  # per-band candidate capacity
    parts = []
    truncated = torch.zeros((), dtype=torch.bool, device=q_sigs.device)
    for band in range(b):
        rks, order = torch.sort(rk[band], stable=True)
        left = torch.searchsorted(rks, qk[band])
        right = torch.searchsorted(rks, qk[band], right=True)
        p2, emitted = _emit_from_ranges(left, right - left,
                                        order.to(torch.int32), cap)
        truncated |= emitted > cap
        parts.append(p2)
    cand_s, keep = dedup_pairs(torch.cat(parts))     # (b*cap, 2)
    qv = torch.where(keep, cand_s[:, 0], -1)
    rv = torch.where(keep, cand_s[:, 1], -1)
    dist = hamming_distance(q_sigs[qv.clamp_min(0).long()],
                            r_sigs[rv.clamp_min(0).long()])
    out, count = compact_pairs((qv, rv, dist), keep & (dist <= d), max_pairs)
    return out, count, truncated


def pairs_to_set(pairs) -> set[tuple[int, int]]:
    """Host-side helper: valid (q, r) rows of a pair buffer as a set."""
    arr = (pairs.cpu().numpy() if isinstance(pairs, torch.Tensor)
           else np.asarray(pairs))
    return {(int(a), int(b)) for a, b, *_ in arr if a >= 0}
