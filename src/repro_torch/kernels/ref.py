"""Plain torch twins of the CUDA kernels (the correctness contract).

A CPU tensor given to a wrapper in ``ops.py`` runs here; on the card,
``chip_smoke.py`` holds each kernel against its twin on the same inputs.
Every output is integer and the comparison is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from ..align.gotoh import wave_scores as wave_scores_ref  # twin of K3
from ..core.hamming import hamming_distance


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


def hamming_dist_ref(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Twin of K2: (Q, nw) x (R, nw) -> (Q, R) int32, XOR + SWAR popcount."""
    return hamming_distance(q[:, None, :], r[None, :, :])


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
