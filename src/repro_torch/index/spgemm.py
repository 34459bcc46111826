"""Candidate generation as one masked sparse-matrix product (SpGEMM).

A band's bucket CSR ``(keys, offsets, ids)`` is the bucket-major CSR of a
sequence x bucket incidence matrix A (``repro/index/spgemm.py``). Which
sequences share a bucket is the Boolean-semiring product AᵀA, and each
join is a mask over it:

* self-join — the strict upper triangle over one slab (``mask="upper"``):
  entry p pairs with every later member of its own bucket, so each
  unordered pair is emitted once. Band-stacked, this is kernel K5
  (:func:`spgemm_self_slab`);
* delta join — ``Aᵀ_delta · A_resident`` (``mask="cross"``), plain torch
  as in the reference;
* probe — a row slice of ``Aᵀ_query · A_index``
  (:func:`row_product_positions`).

Pair buffers are fixed-capacity ``(cap, 2)`` int32 with -1 past the true
count; capacities are sized on the host in int64, so nothing truncates
when ``cap >= true demand``. CSR keys and probe keys are int64 tensors
holding uint32 values: torch's uint32 has no ``searchsorted``, and an
int32 view would reorder keys >= 2^31.
"""
from __future__ import annotations

import torch

from ..core.hamming import hamming_distance
from ..core.join import pack_unique_pairs
from ..kernels import ops
from ..kernels.ref import entry_buckets, upper_window_pairs, window_pairs


# ------------------------------------------------------------ structural join
def match_buckets(keys: torch.Tensor, csr_keys: torch.Tensor,
                  csr_offsets: torch.Tensor):
    """For each key (..., B), the member window ``[start, end)`` of the
    bucket with that key in the sorted ``csr_keys`` (..., U) (empty when no
    bucket matches); ``csr_offsets`` is (..., U+1)."""
    U = csr_keys.shape[-1]
    pos = torch.searchsorted(csr_keys, keys)      # first occurrence (left)
    pos_c = pos.clamp(0, max(U - 1, 0))
    match = (pos < U) & (torch.gather(csr_keys, -1, pos_c) == keys)
    start = torch.gather(csr_offsets, -1, pos_c)
    nxt = torch.gather(csr_offsets, -1, (pos_c + 1).clamp(0, U))
    end = torch.where(match, nxt, start)
    return start, end


def masked_pair_product(loffs, lids, *, cap: int, mask: str = "upper",
                        lkeys=None, rkeys=None, roffs=None, rids=None):
    """One band's masked semiring product as a flat (cap, 2) pair buffer.

    ``mask="upper"``: the strict upper triangle of AᵀA over the
    (loffs, lids) slab, ``cnt[p] = bucket_end(p) - 1 - p`` (K5's
    contract, :func:`repro_torch.kernels.ref.upper_window_pairs`).
    ``mask="cross"``: ``Aᵀ_left · A_right`` — each left entry pairs with
    every member of the right bucket with its key (needs ``lkeys``,
    ``rkeys``, ``roffs``, ``rids``). Slab padding is inert under both.
    """
    E = lids.shape[0]
    pos = torch.arange(E, dtype=torch.int64, device=lids.device)
    loffs = loffs.to(torch.int64)
    if mask == "upper":
        return upper_window_pairs(loffs, lids, cap=cap)
    if mask != "cross":
        raise ValueError(f"unknown SpGEMM mask {mask!r}")
    Ul = lkeys.shape[0]
    u = entry_buckets(loffs, E).clamp(0, max(Ul - 1, 0))
    start, end = match_buckets(lkeys[u], rkeys, roffs.to(torch.int64))
    cnt = torch.where(pos < loffs[-1], end - start, 0)
    return window_pairs(lids, start, cnt, rids, cap=cap)


# ------------------------------------------------------- band-stacked slabs
def spgemm_self_slab(offs_s: torch.Tensor, ids_s: torch.Tensor, *,
                     cap: int) -> torch.Tensor:
    """Upper-mask products of band-stacked slabs: offsets (G, U+1), ids
    (G, E) -> (G, cap, 2) int32, -1 past each band's true count. Kernel K5
    on CUDA, its plain twin on the CPU (``kernels/ops.py``)."""
    return ops.emit_upper_pairs(offs_s, ids_s, cap=cap)


def spgemm_cross_slab(dkeys_s, doffs_s, dids_s, rkeys_s, roffs_s, rids_s,
                      *, cap: int) -> torch.Tensor:
    """Cross-mask products of band-stacked delta x resident slabs ->
    (G, cap, 2) int32 (plain torch, as the reference's jnp form)."""
    return torch.stack([masked_pair_product(
        do, di, cap=cap, mask="cross", lkeys=dk, rkeys=rk, roffs=ro,
        rids=ri) for dk, do, di, rk, ro, ri in zip(
            dkeys_s, doffs_s, dids_s, rkeys_s, roffs_s, rids_s)])


# ------------------------------------------------- dup-free keyed self-join
def upper_keys_dupfree(pairs: torch.Tensor, band_f: torch.Tensor,
                       band_keys_nb: torch.Tensor, sigs: torch.Tensor,
                       d: int | None, *, stride: int) -> torch.Tensor:
    """Upper-mask pair buffers (G, cap, 2) -> packed sort keys
    ``lo*stride + hi`` (G, cap) int32, -1 on empty slots, on cross-band
    duplicates and on Hamming failures.

    Under the band layout a sequence occupies one bucket per band, so a
    pair repeats only across bands: it is a duplicate iff its two rows
    agree in a band earlier than the slab's own (``band_f`` (G,)). The
    reference emits and masks in one pass; here the emission is
    :func:`spgemm_self_slab` (K5 on CUDA) and this is the mask.
    """
    lo, hi = pairs[..., 0], pairs[..., 1]
    lc, hc = lo.clamp_min(0).long(), hi.clamp_min(0).long()
    eq = band_keys_nb[lc] == band_keys_nb[hc]               # (G, cap, nb)
    nb = band_keys_nb.shape[1]
    earlier = (torch.arange(nb, device=pairs.device)[None, None, :]
               < band_f.to(pairs.device)[:, None, None])
    keep = (lo >= 0) & ~torch.any(eq & earlier, dim=-1)
    if d is not None:
        keep &= hamming_distance(sigs[lc], sigs[hc]) <= d
    return torch.where(keep, lo * stride + hi, -1)


def spgemm_join_self_keys(offs_f, ids_f, band_f, band_keys_nb, sigs,
                          *, cap: int, out_cap: int, d: int | None):
    """The dup-free batch self-join (band layout, ids packable into one
    int32 key: ``sigs.shape[0] <= PACKED_KEY_MAX_ID``). Duplicates and
    Hamming failures are masked at emission, so the pack is one sort of
    the key stream (-1 slots sort first) and one clipped gather. Returns
    (pairs (out_cap, 2) int32, count) — the output of
    :func:`spgemm_join_self`, bit for bit."""
    stride = sigs.shape[0] + 1
    ks = torch.sort(upper_keys_dupfree(
        spgemm_self_slab(offs_f, ids_f, cap=cap), band_f, band_keys_nb,
        sigs, d, stride=stride).reshape(-1)).values
    M = ks.shape[0]
    n_inv = torch.searchsorted(ks, torch.zeros(1, dtype=ks.dtype,
                                               device=ks.device))[0]
    count = M - n_inv
    j = torch.arange(out_cap, device=ks.device)
    o = ks[(j + n_inv).clamp(0, M - 1)]
    ok = j < count
    o0 = torch.div(o, stride, rounding_mode="floor")
    pairs = torch.stack([torch.where(ok, o0, -1),
                         torch.where(ok, o - o0 * stride, -1)], dim=-1)
    return pairs.to(torch.int32), count


# ------------------------------------------------------------ probe row slice
def row_product_positions(qkeys, csr_keys, csr_offsets, *, cap: int, E: int):
    """Row slice of the query x index product: qkeys (..., B) -> (entry
    positions (..., B, cap) clipped into [0, E), ok (..., B, cap) —
    position is a real member of the matched bucket, size (..., B) int32 —
    the *true* matched-bucket size, which may exceed cap)."""
    start, end = match_buckets(qkeys, csr_keys, csr_offsets)
    size = (end - start).to(torch.int32)
    idx = start[..., None] + torch.arange(cap, device=qkeys.device)
    ok = idx < end[..., None]
    return idx.clamp(0, max(E - 1, 0)), ok, size


# --------------------------------------------------------------- fused join
def spgemm_pack(cand: torch.Tensor, sigs: torch.Tensor, *, out_cap: int,
                d: int | None):
    """Dedup + filter + compact an already emitted (M, 2) candidate buffer
    (the delta join's ragged merge tail); every id < ``sigs.shape[0]``."""
    return pack_unique_pairs(cand, out_cap=out_cap, id_bound=sigs.shape[0],
                             sigs=sigs, d=d)


def spgemm_join_self(offs_f, ids_f, sigs, *, cap: int, out_cap: int,
                     d: int | None):
    """The batch self-join: upper-mask AᵀA over every (shard, band) slab
    (K5 on CUDA), cross-band dedup, optional exact Hamming filter and
    compaction, all on the slabs' device. offs_f (G, U+1), ids_f (G, E).
    Returns (pairs (out_cap, 2) int32, count); the only host sync the
    caller pays is ``int(count)``."""
    cand = spgemm_self_slab(offs_f, ids_f, cap=cap).reshape(-1, 2)
    return spgemm_pack(cand, sigs, out_cap=out_cap, d=d)
