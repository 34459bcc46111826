"""Band keys for the pigeonhole banding of the bucket index.

Split the f signature bits into ``bands >= d+1`` disjoint groups: any pair
within Hamming distance d agrees exactly on at least one band, so equal
band keys are the candidate test (``repro/core/join.py``). The flip, band
and dense joins themselves are not ported yet.

Keys are int64 tensors holding uint32 values: torch's uint32 has no shifts
and no ``searchsorted``, and an int32 view would reorder keys >= 2^31.
"""
from __future__ import annotations

import numpy as np
import torch

from .hamming import hamming_distance
from .simhash import unpack_bits

_M32 = 0xFFFFFFFF


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
