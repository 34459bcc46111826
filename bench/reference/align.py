"""Plain reference of the re-rank's score: Smith-Waterman local alignment
with BLOSUM62 and a linear gap of -4, best cell of the matrix.

    H[i][j] = max(0, H[i-1][j-1] + B(q_i, r_j), H[i-1][j] - 4, H[i][j-1] - 4)

A row is computed from the row above in two steps: E[j] = max(0, diagonal,
up) for every j, then the run of left moves, H[j] = max over t <= j of
E[t] - 4 (j - t), which is a running maximum of E[t] + 4t, less 4j.
Cells outside a pair's lengths are scored far below zero, so they never
hold the best cell.
"""
from __future__ import annotations

import torch

from .tables import BLOSUM62, PAD

GAP = 4
FAR = -(1 << 20)


def sw_scores(qs: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """(P, Lq) x (P, Lr) int8 residues, PAD-padded, -> (P,) int32 best
    local alignment scores (0 for an all-PAD row). Every value stays far
    inside int32: a score is at most 11 a residue."""
    dev = qs.device
    table = torch.full((21, 21), FAR, dtype=torch.int32, device=dev)
    table[:20, :20] = torch.as_tensor(BLOSUM62, device=dev)
    P, Lq = qs.shape
    Lr = rs.shape[1]
    r = rs.to(torch.int64)
    ramp = GAP * torch.arange(1, Lr + 1, device=dev, dtype=torch.int32)
    prev = torch.zeros((P, Lr + 1), dtype=torch.int32, device=dev)
    best = torch.zeros((P,), dtype=torch.int32, device=dev)
    for i in range(Lq):
        s = table[qs[:, i].to(torch.int64)[:, None], r]        # (P, Lr)
        e = torch.maximum(prev[:, :-1] + s, prev[:, 1:] - GAP).clamp_min(0)
        h = torch.cummax(e + ramp, dim=1).values - ramp
        best = torch.maximum(best, h.amax(dim=1))
        prev = torch.cat([prev[:, :1], h], dim=1)
    return best


def pad_rows(ids: torch.Tensor, lens: torch.Tensor, rows: torch.Tensor,
             width: int) -> torch.Tensor:
    """The residues of ``rows`` of a corpus, PAD past each length, as a
    (len(rows), width) block."""
    block = torch.full((rows.shape[0], width), PAD, dtype=torch.int8,
                       device=ids.device)
    w = min(width, ids.shape[1])
    block[:, :w] = ids[rows, :w]
    pos = torch.arange(width, device=ids.device)
    return block.masked_fill_(pos[None, :] >= lens[rows][:, None], PAD)
