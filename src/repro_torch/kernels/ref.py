"""Plain torch twins of the CUDA kernels (the correctness contract).

A CPU tensor given to a wrapper in ``ops.py`` runs here; on the card,
``chip_smoke.py`` holds each kernel against its twin on the same inputs.
Every output is integer and the comparison is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from ..align.gotoh import wave_scores as wave_scores_ref  # twin of K3
from ..align.smith_waterman import GAP, NEG, rowwave_rows
from ..core.alphabet import ALPHABET_SIZE, BLOSUM62_PADDED, PAD
from ..core.hamming import hamming_distance
from ..core.shingle import extract_shingles, shingle_ids
from ..core.simhash import pack_bits


def _exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 matrix product. torch has no integer matmul on CUDA, so there
    the product runs in float64, exact because every partial sum is an
    integer far below 2^53; on the CPU it runs in int32."""
    if a.is_cuda:
        return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)
    return a @ b


def siggen_accumulate_ref(rows: torch.Tensor, cb: torch.Tensor,
                          H: torch.Tensor, T: int, *,
                          block: int = 16384) -> torch.Tensor:
    """Twin of K1: (S, D) x (W, D) x (W, f) -> (S, f) int32, the score
    matrix built ``block`` rows at a time."""
    cbT = cb.to(torch.int32).T
    Hi = H.to(torch.int32)
    out = torch.empty((rows.shape[0], H.shape[1]), dtype=torch.int32,
                      device=rows.device)
    for i in range(0, rows.shape[0], block):
        scores = _exact_mm(rows[i:i + block].to(torch.int32), cbT)
        wts = torch.where(scores >= T, scores, 0)
        out[i:i + block] = _exact_mm(wts, Hi)
    return out


def table_sums_ref(ids: torch.Tensor, lengths: torch.Tensor,
                   table: torch.Tensor, *, k: int) -> torch.Tensor:
    """Twin of ``table_sums``: every shingle's word id, invalid ones sent
    to row W = 20^k, gathers its (N, S, ...) table rows; their int64 sum
    over S gives a contribution table's packed signs (N, f//32) int32, or
    a count table's sums cast to (N,) int32."""
    sh, _ = extract_shingles(ids, lengths, k)
    wid = shingle_ids(sh)
    V = torch.sum(table[torch.where(wid >= 0, wid, ALPHABET_SIZE**k)], dim=1)
    if table.dim() == 2:
        return pack_bits(V >= 0)
    return V.to(torch.int32)


def hamming_dist_ref(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Twin of K2: (Q, nw) x (R, nw) -> (Q, R) int32, XOR + SWAR popcount."""
    return hamming_distance(q[:, None, :], r[None, :, :])


def hamming_count_ref(q: torch.Tensor, r: torch.Tensor, d: int) -> torch.Tensor:
    """Twin of K6: (Q, nw) x (R, nw) -> (Q,) int32, the number of refs
    within Hamming distance ``d`` of each query."""
    return (hamming_dist_ref(q, r) <= d).sum(1).to(torch.int32)


def sw_affine_ref(q, r, gap_open: int = -11, gap_extend: int = -1):
    """Host Gotoh oracle: best local score of one unpadded encoded pair,
    walking every cell with true -inf gap-lane boundaries. Returns
    (best_score, H) with H the (Lq+1, Lr+1) int64 DP matrix."""
    from ..core.alphabet import BLOSUM62_PADDED

    q = np.asarray(q, np.int64)
    r = np.asarray(r, np.int64)
    sub = BLOSUM62_PADDED[q][:, r].astype(np.int64)
    Lq, Lr = len(q), len(r)
    NEGI = -(1 << 40)
    H = np.zeros((Lq + 1, Lr + 1), np.int64)
    E = np.full((Lq + 1, Lr + 1), NEGI, np.int64)
    F = np.full((Lq + 1, Lr + 1), NEGI, np.int64)
    best = 0
    for i in range(1, Lq + 1):
        for j in range(1, Lr + 1):
            E[i, j] = max(E[i, j - 1] + gap_extend, H[i, j - 1] + gap_open)
            F[i, j] = max(F[i - 1, j] + gap_extend, H[i - 1, j] + gap_open)
            H[i, j] = max(0, H[i - 1, j - 1] + sub[i - 1, j - 1],
                          E[i, j], F[i, j])
            best = max(best, int(H[i, j]))
    return best, H


def ungapped_scores_ref(qs: torch.Tensor, rs: torch.Tensor,
                        x: int) -> torch.Tensor:
    """Twin of K4: (B, Lq) x (B, Lr) int8 -> (B,) int32 best ungapped
    X-drop run scores, one query row at a time with the carries indexed
    by reference column (the diagonal predecessor is a right shift), as
    ``repro/align/smith_waterman.py::_ungapped_pair``. A cell with PAD on
    either side scores NEG, which restarts the run."""
    B, Lq = qs.shape
    Lr = rs.shape[1]
    dev = qs.device
    table = torch.as_tensor(BLOSUM62_PADDED, dtype=torch.int32, device=dev)
    q = qs.to(torch.int64)
    r = rs.to(torch.int64)
    q = torch.where((q >= 0) & (q < ALPHABET_SIZE), q, PAD)
    r = torch.where((r >= 0) & (r < ALPHABET_SIZE), r, PAD)
    z = torch.zeros((B, Lr), dtype=torch.int32, device=dev)
    zcol = z[:, :1]
    cur, rbest = z, z
    best = torch.zeros((B,), dtype=torch.int32, device=dev)
    for i in range(Lq):
        qi = q[:, i:i + 1]
        s = torch.where((qi != PAD) & (r != PAD), table[qi, r], NEG)
        c = torch.cat([zcol, cur[:, :-1]], dim=1) + s
        rb_s = torch.cat([zcol, rbest[:, :-1]], dim=1)
        drop = (c <= 0) | (rb_s - c > x)
        cur = torch.where(drop, 0, c)
        rbest = torch.where(drop, 0, torch.maximum(rb_s, cur))
        best = torch.maximum(best, cur.amax(dim=1))
    return best


def sw_rowwave_ref(qs: torch.Tensor, rs: torch.Tensor, *,
                   gap: int = GAP) -> torch.Tensor:
    """Twin of K7: row-wave linear-gap SW best scores, (B, Lq) x (B, Lr)
    int8 -> (B,) int32. The rows run along the shorter side (the score is
    the same with the sides swapped: BLOSUM62 and the gap are symmetric),
    so a long chain against a short one takes few rows."""
    if qs.shape[1] > rs.shape[1]:
        qs, rs = rs, qs
    best = torch.zeros((qs.shape[0],), dtype=torch.int32, device=qs.device)
    for row in rowwave_rows(qs, rs, gap=gap):
        best = torch.maximum(best, row.amax(dim=1))
    return best


def entry_buckets(offsets: torch.Tensor, n_entries: int) -> torch.Tensor:
    """Owning bucket of each CSR entry position (E,) int64; entries past
    ``offsets[-1]`` (slab padding) resolve past the last bucket and own
    empty windows under every mask."""
    pos = torch.arange(n_entries, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets, pos, right=True) - 1


def window_pairs(left_ids, win_start, cnt, right_ids, *, cap: int):
    """Flatten per-entry partner windows into a fixed (cap, 2) buffer:
    entry p owns ``cnt[p]`` pairs against ``right_ids[win_start[p] + j]``;
    a prefix sum maps slots back to (entry, partner). Pairs come out as
    (min, max); rows past the total are -1. The caller guarantees
    ``cap >= sum(cnt)``."""
    E = left_ids.shape[0]
    Er = right_ids.shape[0]
    dev = left_ids.device
    cum = torch.zeros(E + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(cnt.to(torch.int64), 0)
    slots = torch.arange(cap, dtype=torch.int64, device=dev)
    p = (torch.searchsorted(cum, slots, right=True) - 1).clamp(0, max(E - 1,
                                                                     0))
    partner = right_ids[(win_start[p] + (slots - cum[p])).clamp(
        0, max(Er - 1, 0))]
    a = left_ids[p]
    valid = slots < cum[-1]
    return torch.stack([torch.where(valid, torch.minimum(a, partner), -1),
                        torch.where(valid, torch.maximum(a, partner), -1)],
                       dim=-1).to(torch.int32)


def upper_window_pairs(offs: torch.Tensor, ids: torch.Tensor, *,
                       cap: int) -> torch.Tensor:
    """One band of K5: the strict upper triangle of AᵀA over the
    (offs (U+1,), ids (E,)) slab -> (cap, 2) int32. Entry p pairs with
    the ``cnt[p] = bucket_end(p) - 1 - p`` later members of its bucket;
    padded offsets repeat the end, so padded entries own nothing."""
    E = ids.shape[0]
    offs = offs.to(torch.int64)
    pos = torch.arange(E, dtype=torch.int64, device=ids.device)
    end = offs[(entry_buckets(offs, E) + 1).clamp(0, offs.shape[0] - 1)]
    cnt = (end - 1 - pos).clamp_min(0)
    return window_pairs(ids, pos + 1, cnt, ids, cap=cap)


def upper_pairs_ref(offs_s: torch.Tensor, ids_s: torch.Tensor, *,
                    cap: int) -> torch.Tensor:
    """Twin of K5: band-stacked upper-mask emission, offsets (G, U+1) and
    ids (G, E) -> (G, cap, 2) int32, one band at a time through
    :func:`upper_window_pairs`."""
    return torch.stack([upper_window_pairs(o, i, cap=cap)
                        for o, i in zip(offs_s, ids_s)])
