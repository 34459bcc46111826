"""BLAST-style neighbouring-word generation, restated as dense linear algebra.

The score of shingle s against every word w of the 20^k codebook is

    score[s, w] = sum_i B62[s_i, w_i] = rows(s) @ onehot(codebook)^T

— one product of (S, k*21) x (k*21, W), the operand of kernel K1
(``repro_torch/kernels/siggen.py``). Neighbours are the words with
``score >= T`` (BLAST's semantics; see ``repro/core/neighbors.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..util import full_float32_matmul
from .alphabet import ALPHABET_SIZE, BLOSUM62_PADDED


@functools.lru_cache(maxsize=8)
def codebook(k: int) -> np.ndarray:
    """All 20^k words as (W, k) int8, word id = base-20 big-endian digits."""
    W = ALPHABET_SIZE**k
    ids = np.arange(W, dtype=np.int64)
    cols = []
    for i in range(k - 1, -1, -1):
        cols.append((ids // (ALPHABET_SIZE**i)) % ALPHABET_SIZE)
    return np.stack(cols, axis=-1).astype(np.int8)


@functools.lru_cache(maxsize=8)
def codebook_onehot(k: int) -> np.ndarray:
    """Codebook as (W, k*(ALPHABET_SIZE+1)) one-hot int8 matmul operand."""
    cb = codebook(k)
    W = cb.shape[0]
    A = ALPHABET_SIZE + 1
    oh = np.zeros((W, k, A), dtype=np.int8)
    np.put_along_axis(oh, cb[..., None].astype(np.int64), 1, axis=-1)
    return oh.reshape(W, k * A)


def shingle_rows(shingles: torch.Tensor) -> torch.Tensor:
    """Per-shingle BLOSUM rows: (..., k) ids -> (..., k*(A+1)) int32.

    rows[..., i*(A+1) + a] = B62P[shingle_i, a]; PAD rows are all-zero so
    padded shingles score 0 against every word.
    """
    B = torch.as_tensor(BLOSUM62_PADDED, device=shingles.device)
    r = B[shingles.to(torch.int64)]                  # (..., k, 21) int32
    return r.reshape(*shingles.shape[:-1], -1)


def neighbor_scores(shingles: torch.Tensor, k: int) -> torch.Tensor:
    """Dense neighbour scores (..., W) int32 via the codebook product, on
    the shingles' device.

    cuBLAS has no int32 GEMM, so the product runs in float32 and is cast
    back: each output sums at most k nonzero terms of |value| <= 11, so
    every partial sum is an integer far below 2^24 and float32 is exact.
    TF32 would be exact too (its 10-bit mantissa holds the operands, and
    it accumulates in float32), but the precision is pinned to full
    float32 for the call so that no caller's setting is relied on.
    """
    rows = shingle_rows(shingles).to(torch.float32)   # (..., k*(A+1))
    C = torch.as_tensor(codebook_onehot(k), device=shingles.device)
    with full_float32_matmul():
        s = rows @ C.T.to(torch.float32)                # (..., W)
    return s.to(torch.int32)


def neighbor_weights(shingles: torch.Tensor, k: int, T: int) -> torch.Tensor:
    """Thresholded feature weights: score if score >= T else 0 (paper §3.1)."""
    s = neighbor_scores(shingles, k)
    return torch.where(s >= T, s, 0)
