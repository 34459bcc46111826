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
