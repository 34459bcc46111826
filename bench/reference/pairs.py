"""Plain reference of the pair dump: every (query, reference) pair of valid
sequences whose signatures lie within Hamming distance d, by brute force.

All distances come from one product of +1/-1 bit vectors a block of
queries at a time: a . b = f - 2 * hamming(a, b). The products are small
integers (|a . b| <= f), which half precision holds exactly on the card;
the CPU uses float32.
"""
from __future__ import annotations

import numpy as np
import torch

from .simhash import signs

BLOCK_CELLS = 1 << 30       # (queries x references) products of one block


def encode(q: np.ndarray, r: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """One int64 a pair: q << 24 | r << 4 | dist (r < 2^20, dist < 16)."""
    return (q.astype(np.int64) << 24) | (r.astype(np.int64) << 4) | dist


def pairs_within(q_sigs: np.ndarray, q_valid: np.ndarray,
                 r_sigs: np.ndarray, r_valid: np.ndarray, *, f: int, d: int,
                 device, drop_at: int | None = None) -> np.ndarray:
    """Sorted int64 codes (:func:`encode`) of every pair within ``d``.
    ``drop_at`` leaves out the pairs at exactly that distance (the
    control's broken guarantee)."""
    dtype = torch.float16 if torch.device(device).type == "cuda" else \
        torch.float32
    r_rows = np.nonzero(r_valid)[0]
    q_rows = np.nonzero(q_valid)[0]
    R = signs(r_sigs[r_rows], f, device, dtype)
    Q = signs(q_sigs[q_rows], f, device, dtype)
    r_ids = torch.as_tensor(r_rows, device=device)
    q_ids = torch.as_tensor(q_rows, device=device)
    step = max(1, BLOCK_CELLS // max(1, R.shape[0]))
    out = []
    for a in range(0, Q.shape[0], step):
        dot = Q[a:a + step] @ R.T
        qi, ri = torch.nonzero(dot >= f - 2 * d, as_tuple=True)
        dist = ((f - dot[qi, ri].to(torch.int64)) // 2)
        keep = dist != drop_at if drop_at is not None else slice(None)
        out.append(encode(q_ids[a + qi[keep]].cpu().numpy(),
                          r_ids[ri[keep]].cpu().numpy(),
                          dist[keep].cpu().numpy()))
    codes = np.concatenate(out) if out else np.zeros(0, np.int64)
    return np.sort(codes)
