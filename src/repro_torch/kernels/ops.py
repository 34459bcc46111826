"""Wrappers that route each kernel call by the device of its tensors.

A CUDA tensor goes to the hand-written kernel, or the call raises; a CPU
tensor goes to the kernel's plain twin (``ref.py``). There is no fallback
from one to the other. Each wrapper counts its kernel launches in
:data:`LAUNCHES` — a run can show that its main path went through the
kernels — and counts nothing when the twin runs. The count is one for each
call of a kernel's launcher, whatever number of grids that call runs: K1
runs one for each 256-column slice of H, K5 three (two scan passes and the
emission). While
:data:`RECORDED` is a dict, each wrapper also keeps there a copy of the
first inputs it launches its kernel on, so a smoke run can replay the
main path's own shapes against the twins.
"""
from __future__ import annotations

import torch

from . import ref

#: kernel launches since the last :func:`reset_launches`, by kernel
LAUNCHES = {"siggen_accumulate": 0, "hamming_dist": 0, "hamming_count": 0,
            "wave_scores_linear": 0, "wave_scores_affine": 0,
            "ungapped_scores": 0, "upper_pairs": 0, "sw_rowwave": 0,
            "table_sums": 0}

#: ``None``, or a dict that collects, per kernel, the first launch's
#: ``(args, kwargs)`` as the kernel launcher takes them
RECORDED: dict | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launch(name: str, launcher, *args, **kw) -> torch.Tensor:
    """Launch one kernel; count it and, while recording, keep its first
    inputs."""
    out = launcher(*args, **kw)
    LAUNCHES[name] += 1
    if RECORDED is not None and name not in RECORDED:
        RECORDED[name] = (tuple(a.clone() for a in args), dict(kw))
    return out


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on CUDA, False when every one is on the
    CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands on devices {sorted(kinds)}: the kernels run "
                     f"on CUDA and their twins on the CPU")


def signatures_fused(rows, cb, H, *, T: int) -> torch.Tensor:
    """Fused SimHash accumulation V (S, f) int32 (kernel K1)."""
    # zero padding of ragged rows/words is exact only for T >= 1 (a zero
    # operand scores 0 < T); the reference asserts the same
    if T < 1:
        raise ValueError("padding exactness requires T >= 1 (paper uses T >= 11)")
    if _on_cuda(rows, cb, H):
        from .siggen import siggen_accumulate
        return _launch("siggen_accumulate", siggen_accumulate, rows, cb, H,
                       T=T)
    return ref.siggen_accumulate_ref(rows, cb, H, T)


def all_pairs_hamming(q, r) -> torch.Tensor:
    """All-pairs Hamming distances (Q, R) int32 (kernel K2)."""
    if _on_cuda(q, r):
        from .hamming import hamming_dist
        return _launch("hamming_dist", hamming_dist, q, r)
    return ref.hamming_dist_ref(q, r)


def hamming_counts(q, r, d: int) -> torch.Tensor:
    """Per-query counts of references within Hamming distance ``d``:
    (Q,) int32 (kernel K6)."""
    if _on_cuda(q, r):
        from .hamming import hamming_count
        return _launch("hamming_count", hamming_count, q, r, d=int(d))
    return ref.hamming_count_ref(q, r, d)


def wavefront_scores(qs, rs, *, gap_mode: str = "linear",
                     gap_open: int | None = None,
                     gap_extend: int | None = None) -> torch.Tensor:
    """Batched SW best scores (B,) int32 of a (B, Lq) x (B, Lr) pair block
    via the anti-diagonal sweep (kernel K3), linear or affine gaps."""
    from ..align.gotoh import GAP_EXTEND, GAP_OPEN
    from ..align.smith_waterman import GAP

    if gap_mode == "affine":
        go = GAP_OPEN if gap_open is None else int(gap_open)
        ge = GAP_EXTEND if gap_extend is None else int(gap_extend)
    elif gap_mode == "linear":
        go = ge = GAP if gap_open is None else int(gap_open)
    else:
        raise ValueError(f"unknown gap_mode {gap_mode!r}")
    affine = gap_mode == "affine"
    if _on_cuda(qs, rs):
        from .sw import wave_scores
        return _launch(f"wave_scores_{gap_mode}", wave_scores, qs, rs,
                       gap_open=go, gap_extend=ge, affine=affine)
    return ref.wave_scores_ref(qs, rs, gap_open=go, gap_extend=ge,
                               affine=affine)


#: the X-drop margin that stands for "no drop" (``x=None``): no run of
#: BLOSUM62 scores over sequences the kernels take falls 2^30 below its best
NO_XDROP = 1 << 30


def ungapped_wave_scores(qs, rs, *, x: int | None) -> torch.Tensor:
    """Batched ungapped X-drop prefilter scores (B,) int32 of a
    (B, Lq) x (B, Lr) pair block (kernel K4); ``x=None`` is no drop."""
    x = NO_XDROP if x is None else min(int(x), NO_XDROP)
    if _on_cuda(qs, rs):
        from .sw import ungapped_scores
        return _launch("ungapped_scores", ungapped_scores, qs, rs, x=x)
    return ref.ungapped_scores_ref(qs, rs, x)


def sw_rowwave_scores(qs, rs) -> torch.Tensor:
    """Batched row-wave linear-gap SW best scores (B,) int32 of a
    (B, Lq) x (B, Lr) pair block (kernel K7)."""
    from ..align.smith_waterman import GAP
    if _on_cuda(qs, rs):
        from .sw import sw_rowwave
        return _launch("sw_rowwave", sw_rowwave, qs, rs, gap=GAP)
    return ref.sw_rowwave_ref(qs, rs, gap=GAP)


def emit_upper_pairs(offs_s, ids_s, *, cap: int) -> torch.Tensor:
    """Band-stacked upper-mask SpGEMM emission: offsets (G, U+1), ids
    (G, E) -> (G, cap, 2) int32, -1 past each band's true count
    (kernel K5)."""
    if _on_cuda(offs_s, ids_s):
        from .spgemm import upper_pairs
        return _launch("upper_pairs", upper_pairs,
                       offs_s.to(torch.int32).contiguous(),
                       ids_s.to(torch.int32).contiguous(), cap=cap)
    return ref.upper_pairs_ref(offs_s, ids_s, cap=cap)


def _table_k(table: torch.Tensor) -> int:
    """k of a per-word table of 20^k + 1 rows (row 20^k takes the invalid
    shingles); raises for any other row count."""
    from ..core.alphabet import ALPHABET_SIZE
    for k in range(1, 6):
        if table.shape[0] == ALPHABET_SIZE**k + 1:
            return k
    raise ValueError(f"a table of {table.shape[0]} rows is no per-word "
                     f"table: it takes 20^k + 1 rows, k <= 5")


def table_sums(ids, lengths, table) -> torch.Tensor:
    """Job 1's table route (kernel ``table_sums``): per sequence, the sum of
    the table rows of its shingles' word ids, invalid shingles at row W =
    20^k (k from the table's rows). A (W + 1, f) int32 contribution table
    gives the packed signatures (N, f//32) int32 of ``sum >= 0``; a
    (W + 1,) int32 count table the sums (N,) int32, wrapped as the twin's
    int64 sum cast to int32. ids (N, L) int8, lengths (N,) integer."""
    if ids.dtype != torch.int8 or ids.dim() != 2:
        raise TypeError(f"table_sums takes (N, L) int8 residues, got "
                        f"{ids.dtype} of {ids.dim()} dims")
    if table.dtype != torch.int32 or table.dim() not in (1, 2) or (
            table.dim() == 2 and (table.shape[1] % 32 or not table.shape[1])):
        raise TypeError(f"table_sums takes an int32 table (W + 1,) or "
                        f"(W + 1, f), f a multiple of 32; got {table.dtype} "
                        f"{tuple(table.shape)}")
    k = _table_k(table)
    if not (ids.is_contiguous() and table.is_contiguous()):
        raise ValueError("table_sums takes contiguous residues and table")
    if lengths.dim() != 1 or lengths.shape[0] != ids.shape[0] or (
            lengths.dtype.is_floating_point or lengths.dtype == torch.bool):
        raise ValueError(f"table_sums takes (N,) integer lengths, got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if _on_cuda(ids, lengths, table):
        if len({ids.device, lengths.device, table.device}) != 1:
            raise ValueError("table_sums operands must share one device")
        from .tablesum import table_sums as launch
        return _launch("table_sums", launch, ids, lengths, table, k=k)
    return ref.table_sums_ref(ids, lengths, table, k=k)
