"""Anti-diagonal ("wavefront") Smith-Waterman, linear or affine (Gotoh) gaps.

The plain torch sweep of ``repro/align/gotoh.py`` and the twin of kernel K3
(``kernels/csrc/sw.cu``). Every cell on diagonal c depends only on
diagonals c-1 and c-2, so one step is elementwise over (B, Lq) lanes
indexed by query row i (j = c - i):

    H[i, j-1]   -> same lane, previous diagonal        (h1)
    H[i-1, j]   -> shifted lane, previous diagonal     (h1s = shift(h1))
    H[i-1, j-1] -> shifted lane, diagonal c-2          (h2s)

Affine gaps add the E/F lanes with the same structure:

    E_c = max(E_{c-1} + extend, H_{c-1} + open)           (gap along j)
    F_c = max(shift(F_{c-1}) + extend, shift(H_{c-1}) + open)
    H_c = max(0, shift(H_{c-2}) + s_c, E_c, F_c)

``open`` is the cost of the FIRST gap residue, ``extend`` of each further
one; ``open == extend`` degenerates exactly to the linear recurrence. The
gap lanes start at 0 instead of -inf: a polluted E/F value is negative and
can never beat H's 0 floor, so H — and the score — is exact.

PAD (and anything outside the alphabet) scores the sentinel ``SENT8`` in
the substitution table, as do cells with j outside [0, Lr): a DP path that
enters a sentinel region never leaves it and never beats the best valid
cell, so scores equal those of the masked row wave.

``sw_wave_linear`` and ``sw_wave_affine`` are the batched entry points:
kernel K3 on the card (the default device), this sweep on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.alphabet import ALPHABET_SIZE, BLOSUM62_PADDED, PAD
from .smith_waterman import GAP, pair_block

GAP_OPEN = -11   # BLOSUM62 companion defaults (BLAST -11/-1)
GAP_EXTEND = -1
SENT8 = -100     # sentinel substitution score of PAD rows/columns


def sentinel_table() -> np.ndarray:
    """(21, 21) int32 BLOSUM62 with the PAD row and column at SENT8."""
    t = BLOSUM62_PADDED.astype(np.int32).copy()
    t[PAD, :] = SENT8
    t[:, PAD] = SENT8
    return t


def lane_dtype(Lq: int, Lr: int) -> torch.dtype:
    """int16 lanes while 11*L < 2^14 (H <= 11*min(Lq, Lr), the largest
    BLOSUM62 diagonal, so carries and h2s + SENT8 stay exact and far from
    the int16 rails); int32 above."""
    return torch.int16 if 11 * max(Lq, Lr) < (1 << 14) else torch.int32


def _residues(x: torch.Tensor) -> torch.Tensor:
    """int8 residues -> int64 ids with anything outside the alphabet at PAD."""
    x = x.to(torch.int64)
    return torch.where((x >= 0) & (x < ALPHABET_SIZE), x, PAD)


def wave_scores(qs: torch.Tensor, rs: torch.Tensor, *, gap_open: int,
                gap_extend: int, affine: bool) -> torch.Tensor:
    """(B, Lq) x (B, Lr) int8 residues -> (B,) int32 best local scores.

    The sweep keeps one lane per query row, so it runs with the shorter
    side as the query: the best score is the same with the sides swapped
    (BLOSUM62, the sentinel table and the gaps are symmetric, and E and F
    trade places), and a 34,350-residue chain against a short one costs
    the short side's lanes a diagonal."""
    if qs.shape[1] > rs.shape[1]:
        qs, rs = rs, qs
    B, Lq = qs.shape
    Lr = rs.shape[1]
    dt = lane_dtype(Lq, Lr)
    dev = qs.device
    table = torch.as_tensor(sentinel_table().reshape(-1), device=dev)
    qrow = _residues(qs) * (ALPHABET_SIZE + 1)        # (B, Lq)
    r = _residues(rs)                                 # (B, Lr)
    i = torch.arange(Lq, device=dev)
    z = torch.zeros((B, Lq), dtype=dt, device=dev)
    zcol = torch.zeros((B, 1), dtype=dt, device=dev)

    def shift(x):
        return torch.cat([zcol, x[:, :-1]], dim=1)

    def scores(c0, c1):
        """(B, c1 - c0, Lq) scores of diagonals c0..c1-1, SENT8 outside."""
        j = torch.arange(c0, c1, device=dev)[:, None] - i
        s = table[qrow[:, None, :] + r[:, j.clamp(0, Lr - 1)]]
        return torch.where((j >= 0) & (j < Lr), s, SENT8).to(dt)

    ndiag = Lq + Lr - 1
    step = max(1, (1 << 22) // max(B * Lq, 1))   # diagonals a score block
    h1 = h2s = e1 = f1 = best = z
    for c in range(ndiag):
        if c % step == 0:
            block = scores(c, min(ndiag, c + step))
        s = block[:, c % step]
        h1s = shift(h1)
        if affine:
            e = torch.maximum(e1 + gap_extend, h1 + gap_open)
            f = torch.maximum(shift(f1) + gap_extend, h1s + gap_open)
            h = torch.maximum((h2s + s).clamp_min(0), torch.maximum(e, f))
            e1, f1 = e, f
        else:
            h = torch.maximum((h2s + s).clamp_min(0),
                              torch.maximum(h1, h1s) + gap_open)
        best = torch.maximum(best, h)
        h1, h2s = h, h1s
    return best.amax(dim=1).to(torch.int32)



def sw_wave_linear(qs, rs, *, gap: int = GAP, device=None) -> torch.Tensor:
    """Batched linear-gap SW scores via the wavefront sweep: (B, Lq) x
    (B, Lr) int8 (PAD-padded) -> (B,) int32 on the device. Scores
    bit-exact with the row wave (``smith_waterman.sw_align_batch``)."""
    from ..kernels import ops
    return ops.wavefront_scores(*pair_block(qs, rs, device),
                                gap_mode="linear", gap_open=gap)


def sw_wave_affine(qs, rs, *, gap_open: int = GAP_OPEN,
                   gap_extend: int = GAP_EXTEND, device=None) -> torch.Tensor:
    """Batched affine-gap (Gotoh) SW scores via the wavefront sweep:
    (B, Lq) x (B, Lr) int8 -> (B,) int32 on the device; bit-exact with
    the oracle ``kernels.ref.sw_affine_ref`` on the unpadded pairs."""
    from ..kernels import ops
    return ops.wavefront_scores(*pair_block(qs, rs, device),
                                gap_mode="affine", gap_open=gap_open,
                                gap_extend=gap_extend)
