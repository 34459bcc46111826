"""The structural key join of candidate generation.

A band's bucket CSR ``(keys, offsets, ids)`` is the bucket-major CSR of a
sequence x bucket incidence matrix A; a probe is a row slice of the
query x index product (``repro/index/spgemm.py``). Only the two functions
the serving probe needs are ported: :func:`match_buckets` and
:func:`row_product_positions`. They work over any leading batch axes, so
all bands probe in one call.

CSR keys and probe keys are int64 tensors holding uint32 values: torch's
uint32 has no ``searchsorted``, and an int32 view would reorder keys
>= 2^31 and break the sorted order the search relies on.
"""
from __future__ import annotations

import torch


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
