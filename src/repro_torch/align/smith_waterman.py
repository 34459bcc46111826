"""Smith-Waterman scoring of gathered pair blocks for the serving re-rank.

``sw_gather_scores`` gathers both sides of each (query, reference) pair
from device-resident corpora and scores the block with one DP sweep:

* ``dp_kernel="wavefront"`` (default) — the anti-diagonal sweep, linear or
  affine gaps: kernel K3 on CUDA (``kernels/csrc/sw.cu``), its plain twin
  (``align/gotoh.py``) on the CPU;
* ``dp_kernel="rowwave"`` — the linear-gap row wave, each row resolved by a
  max-plus prefix scan (H[i, 1:] = cummax(A + c*t) - c*t, c = -GAP). Plain
  torch on the CPU; on CUDA it needs kernel K7, which is not ported yet.

The PID traceback path of the reference is not ported yet.
"""
from __future__ import annotations

import torch

from ..core.alphabet import BLOSUM62_PADDED, PAD

GAP = -4     # linear gap penalty (BLOSUM62-compatible default)
NEG = -10**6  # masked-substitution sentinel (padded positions never win)


def _sub_matrix(qs: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """(B, Lq) x (B, Lr) int8 -> (B, Lq, Lr) int32 substitution scores,
    PAD-masked with NEG."""
    table = torch.as_tensor(BLOSUM62_PADDED, device=qs.device)
    q = qs.to(torch.int64)
    r = rs.to(torch.int64)
    sub = table[q[:, :, None], r[:, None, :]]
    valid = (q != PAD)[:, :, None] & (r != PAD)[:, None, :]
    return torch.where(valid, sub, NEG)


def _rowwave_scores(qs: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """Row-wave linear-gap SW best scores: (B, Lq) x (B, Lr) -> (B,) int32."""
    B, Lq = qs.shape
    Lr = rs.shape[1]
    sub = _sub_matrix(qs, rs)
    c = -GAP
    t = torch.arange(1, Lr + 1, dtype=torch.int32, device=qs.device)
    prev = torch.zeros((B, Lr + 1), dtype=torch.int32, device=qs.device)
    zcol = prev[:, :1]
    best = torch.zeros((B,), dtype=torch.int32, device=qs.device)
    for i in range(Lq):
        a = torch.maximum(prev[:, :-1] + sub[:, i], prev[:, 1:] + GAP)
        a = a.clamp_min(0)
        p = torch.cummax(a + c * t, dim=1).values
        prev = torch.cat([zcol, p - c * t], dim=1)
        best = torch.maximum(best, prev.amax(dim=1))
    return best


def gather_rows(ids_dev: torch.Tensor, lens_dev: torch.Tensor,
                idx: torch.Tensor, L: int) -> torch.Tensor:
    """(N, Lmax) device corpus -> (B, L) PAD-masked block for row indices
    ``idx`` (idx < 0 marks padding slots -> all-PAD rows)."""
    safe = idx.clamp_min(0)
    rows = ids_dev[safe, :min(L, ids_dev.shape[1])]
    if rows.shape[1] < L:       # padded ladder exceeds the corpus width
        rows = torch.nn.functional.pad(rows, (0, L - rows.shape[1]),
                                       value=PAD)
    ln = torch.where(idx >= 0, lens_dev[safe], 0)
    pos = torch.arange(L, device=ids_dev.device)[None, :]
    return torch.where(pos < ln[:, None], rows, PAD).contiguous()


def dp_scores_block(qm, rm, *, dp_kernel: str = "wavefront",
                    gap_mode: str = "linear", gap_open: int | None = None,
                    gap_extend: int | None = None) -> torch.Tensor:
    """Route a gathered (B, Lq) x (B, Lr) pair block to a DP sweep."""
    from ..kernels import ops

    if gap_mode not in ("linear", "affine"):
        raise ValueError(f"unknown gap_mode {gap_mode!r}")
    if dp_kernel not in ("wavefront", "rowwave"):
        raise ValueError(f"unknown dp_kernel {dp_kernel!r}")
    if gap_mode == "affine" and dp_kernel == "rowwave":
        raise ValueError("affine gaps need dp_kernel='wavefront' (the row "
                         "wave's prefix-scan closed form only holds for "
                         "linear penalties)")
    if dp_kernel == "rowwave":
        if qm.is_cuda:
            raise NotImplementedError(
                "dp_kernel='rowwave' on CUDA needs kernel K7 (the port of "
                "repro/kernels/sw.py::sw_scores_kernel), not ported yet; "
                "use dp_kernel='wavefront'")
        return _rowwave_scores(qm, rm)
    return ops.wavefront_scores(qm, rm, gap_mode=gap_mode,
                                gap_open=gap_open, gap_extend=gap_extend)


def sw_gather_scores(q_ids, q_lens, r_ids, r_lens, qi, ri, *,
                     Lq: int, Lr: int, dp_kernel: str = "wavefront",
                     gap_mode: str = "linear", gap_open: int | None = None,
                     gap_extend: int | None = None) -> torch.Tensor:
    """Gather both pair sides from device-resident corpora and score them.
    (qi, ri) (B,) with -1 padding; padding slots score 0."""
    qm = gather_rows(q_ids, q_lens, qi, Lq)
    rm = gather_rows(r_ids, r_lens, ri, Lr)
    return dp_scores_block(qm, rm, dp_kernel=dp_kernel, gap_mode=gap_mode,
                           gap_open=gap_open, gap_extend=gap_extend)
