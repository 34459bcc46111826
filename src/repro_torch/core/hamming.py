"""Hamming distance on packed signatures, and the dense join of job 2.

Signatures are (..., nwords) int32 tensors holding uint32 bit patterns
(f = nwords*32 bits). torch has no popcount operator, so the plain path
counts bits with the SWAR ladder; the CUDA kernels K2 (distances) and K6
(counts within d) use ``__popc``.
"""
from __future__ import annotations

import torch

from ..util import as_unsigned


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit word (SWAR). ``x`` is int64 holding an
    unsigned 32-bit value, so shifts are logical and nothing overflows."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance of packed signatures (broadcasting)."""
    x = as_unsigned(torch.bitwise_xor(a, b))
    return torch.sum(popcount32(x), dim=-1).to(torch.int32)


def all_pairs_hamming(q: torch.Tensor, r: torch.Tensor,
                      block: int = 1024) -> torch.Tensor:
    """(Q, nw) x (R, nw) -> (Q, R) int32 distance matrix, blocked over R.
    Plain torch; the production path is kernel K2
    (``kernels.ops.all_pairs_hamming``)."""
    out = torch.empty((q.shape[0], r.shape[0]), dtype=torch.int32,
                      device=q.device)
    for i in range(0, r.shape[0], block):
        out[:, i:i + block] = hamming_distance(q[:, None, :],
                                               r[None, i:i + block, :])
    return out


# Memory budget of one emission tile of the dense join: its (rows, R) K2
# distances (4 bytes a cell) and their ``<= d`` mask, with room to spare.
_TILE_BYTES = 1 << 30
_TILE_BYTES_PER_CELL = 8


def threshold_pairs(q: torch.Tensor, r: torch.Tensor, d: int,
                    max_pairs: int, *, stages=None):
    """Emit (qid, rid, dist) for all pairs with Hamming distance <= d.

    Returns pairs (min(max_pairs, Q*R), 3) int32 — the reference's buffer
    shape: hits in row-major (qid, rid) order, rows past ``count`` are
    (-1, -1, -1) — and count, a 0-d int64 tensor holding the true number
    of matches (it exceeds max_pairs when the buffer truncated).

    The reference materializes the (Q, R) distance matrix and stable-sorts
    all Q*R cells. Here kernel K6 counts each query's hits first; their
    exclusive cumsum is each query's place in the buffer. Then only the
    queries with hits that start inside the buffer are emitted, a tile of
    rows at a time (K2 distances, ``<= d``, ``nonzero`` in row-major
    order), each tile under ``_TILE_BYTES``: the matrix is never whole.

    ``stages``, where given, is told where the two stages lie, for the
    caller's timing: ``stages.mark()`` as K6's count begins, after the
    exclusive cumsum (the emission begins) and after the last tile, and
    ``stages.tile(rows)`` for every tile of ``rows`` query rows. Neither
    may wait for the device.
    """
    from ..kernels import ops

    if stages is not None:
        stages.mark()
    Q, R = q.shape[0], r.shape[0]
    counts = ops.hamming_counts(q, r, d).to(torch.int64)
    count = counts.sum()
    n_out = min(int(max_pairs), Q * R)
    pairs = torch.full((n_out, 3), -1, dtype=torch.int32, device=q.device)
    offsets = torch.cumsum(counts, 0) - counts
    if stages is not None:
        stages.mark()
    _emit(q, r, d, counts, offsets, pairs, stages)
    if stages is not None:
        stages.mark()
    return pairs, count


def _emit(q, r, d, counts, offsets, pairs, stages) -> None:
    """Write the hits of the queries that start inside ``pairs`` into it,
    a tile of rows at a time."""
    from ..kernels import ops

    n_out, R = pairs.shape[0], r.shape[0]
    emit = torch.nonzero((counts > 0) & (offsets < n_out))[:, 0]
    if len(emit) == 0:
        return
    starts = offsets[emit].cpu()
    step = max(1, _TILE_BYTES // (_TILE_BYTES_PER_CELL * R))
    for i in range(0, len(emit), step):
        rows = emit[i:i + step]
        if stages is not None:
            stages.tile(len(rows))
        dist = ops.all_pairs_hamming(q[rows], r)
        hit = torch.nonzero(dist <= d)
        start = int(starts[i])
        m = min(hit.shape[0], n_out - start)
        hit = hit[:m]
        pairs[start:start + m] = torch.stack(
            [rows[hit[:, 0]], hit[:, 1], dist[hit[:, 0], hit[:, 1]]],
            dim=-1).to(torch.int32)
