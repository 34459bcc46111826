"""The alignment kernels on the card (``csrc/sw.cu``).

* K3 :func:`wave_scores` — wavefront Smith-Waterman best scores, linear
  and affine gaps; replaces ``repro/kernels/sw.py::wave_scores_kernel``.
* K4 :func:`ungapped_scores` — the ungapped X-drop diagonal scan;
  replaces ``repro/kernels/sw.py::ungapped_scores_kernel``.
* K7 :func:`sw_rowwave` — row-wave linear-gap Smith-Waterman best scores;
  replaces ``repro/kernels/sw.py::sw_scores_kernel``.

The source notes in ``csrc/sw.cu`` give each kernel's bound and design.
The plain twins are in :mod:`repro_torch.kernels.ref`; the routing
wrappers in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..obs.jit import trace_sentinel
from ..util import canonical_device
from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
SMEM_BLOCK_MAX = 232_448   # shared memory a block can use on the H100

# K3's launch geometry: csrc/sw.cu picks the same rows per lane; where the
# strip buffers live is decided here (a scratch pointer or none)
WAVE_WARPS = 4                     # pairs (one warp each) per block
WAVE_RPT = tuple(range(4, 33, 4))  # query rows per lane, by Lq
WAVE_SMEM_BUF_MAX = 64 * 1024      # strip buffers in shared memory up to


@dataclass(frozen=True)
class WaveGeometry:
    rpt: int               # query rows per lane; a strip is 32 * rpt rows
    pairs_per_block: int
    strips: int            # strips of the longest query (Lq)
    smem_bytes: int        # dynamic shared memory per block
    scratch_per_pair: int  # int32 strip-buffer words per pair in global
                           # memory (0: the buffers sit in shared memory)


def wave_geometry(Lq: int, Lr: int, affine: bool) -> WaveGeometry:
    """K3's launch geometry for a (B, Lq) x (B, Lr) block: rows per lane
    the smallest of ``WAVE_RPT`` whose strip holds Lq rows (else the
    largest, in as many strips as Lq needs); per warp a 21 x 32 x rpt
    int8 query profile and, with more than one strip, the last row's H
    (and F, affine) of each column, in shared memory while the block's
    buffers fit ``WAVE_SMEM_BUF_MAX`` bytes, else in global scratch."""
    rpt = next((r for r in WAVE_RPT if 32 * r >= Lq), WAVE_RPT[-1])
    strips = -(-Lq // (32 * rpt))
    nbuf = 2 if affine else 1
    prof = WAVE_WARPS * 21 * 32 * rpt
    buf = WAVE_WARPS * 4 * Lr * nbuf if strips > 1 else 0
    in_smem = buf <= WAVE_SMEM_BUF_MAX
    return WaveGeometry(rpt=rpt, pairs_per_block=WAVE_WARPS, strips=strips,
                        smem_bytes=prof + (buf if in_smem else 0),
                        scratch_per_pair=0 if in_smem else nbuf * Lr)


# K7's launch geometry, mirrored by csrc/sw.cu (rw_geometry), which checks
# what the wrapper passes
ROWWAVE_CPT = tuple(range(4, 33, 4))   # reference columns per lane, by Lr
ROWWAVE_WARPS = 4                      # pairs (one warp each) per block, at most


@dataclass(frozen=True)
class RowwaveGeometry:
    cpt: int               # reference columns per lane; a segment is 32 * cpt
    segments: int          # segments of the widest reference (Lr)
    pairs_per_block: int
    smem_bytes: int        # dynamic shared memory per block
    scratch_per_pair: int  # bytes of a pair's buffer in global memory;
                           # 0: all in shared memory


def rowwave_geometry(Lq: int, Lr: int) -> RowwaveGeometry:
    """K7's launch geometry for a (B, Lq) x (B, Lr) block: columns per
    lane the smallest of ``ROWWAVE_CPT`` whose 32 lanes hold Lr columns
    (else the largest, in several segments); per warp a 21 x 32 x cpt int8
    reference profile per segment and, with more than one segment, the H
    row (int32) and a PAD mask word per lane of each segment; as many
    pairs per block (4, 2 or 1) as shared memory holds beside the BLOSUM
    table. Where one pair's buffer does not fit a block (past 8 segments)
    it moves to per-pair global scratch, 4 pairs a block. Lq does not
    enter: the rows are the warp's loop."""
    cpt = next((c for c in ROWWAVE_CPT if 32 * c >= Lr), ROWWAVE_CPT[-1])
    cols = 32 * cpt
    segments = -(-Lr // cols)
    per_warp = 21 * cols * segments
    if segments > 1:
        per_warp += (4 * cols + 4 * 32) * segments
    avail = SMEM_BLOCK_MAX - 4 * 21 * 21
    if per_warp > avail:   # past 8 segments: in per-pair global scratch
        return RowwaveGeometry(cpt=cpt, segments=segments,
                               pairs_per_block=ROWWAVE_WARPS, smem_bytes=0,
                               scratch_per_pair=per_warp)
    ppb = next(p for p in (ROWWAVE_WARPS, 2, 1) if p * per_warp <= avail)
    return RowwaveGeometry(cpt=cpt, segments=segments, pairs_per_block=ppb,
                           smem_bytes=ppb * per_warp, scratch_per_pair=0)


def _table(device, sentinel: bool = True) -> torch.Tensor:
    """BLOSUM62 (21*21,) int32 on ``device``: with the PAD row and column
    at the sentinel (K3), or plain (K4 and K7 mask PAD themselves).
    Uploaded once per device and kind."""
    return _build_table(canonical_device(device), sentinel)


@functools.lru_cache(maxsize=8)
@trace_sentinel("sw_table")
def _build_table(device, sentinel):
    from ..align.gotoh import sentinel_table
    from ..core.alphabet import BLOSUM62_PADDED
    t = sentinel_table() if sentinel else BLOSUM62_PADDED.astype(np.int32)
    return torch.as_tensor(t.reshape(-1), device=device)


def _check_pair_block(name: str, qs: torch.Tensor, rs: torch.Tensor):
    """(B, Lq, Lr) of an int8 (B, Lq) x (B, Lr) pair block, contiguous on
    one device with Lq, Lr >= 1; raises on anything else."""
    if qs.dtype != torch.int8 or rs.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 residues")
    if qs.dim() != 2 or rs.dim() != 2 or qs.shape[0] != rs.shape[0]:
        raise ValueError(f"{name} shapes {tuple(qs.shape)} x "
                         f"{tuple(rs.shape)} do not pair up")
    if not (qs.is_contiguous() and rs.is_contiguous()):
        raise ValueError(f"{name} takes contiguous operands")
    if qs.device != rs.device:
        raise ValueError(f"{name} operands must share one device")
    B, Lq = qs.shape
    Lr = rs.shape[1]
    if Lq < 1 or Lr < 1:
        raise ValueError(f"{name} takes Lq, Lr >= 1, got {Lq}, {Lr}")
    return B, Lq, Lr


def wave_scores(qs: torch.Tensor, rs: torch.Tensor, *, gap_open: int,
                gap_extend: int, affine: bool) -> torch.Tensor:
    """Launch K3: qs (B, Lq), rs (B, Lr) int8 residues, contiguous on one
    CUDA device -> (B,) int32 best local scores."""
    B, Lq, Lr = _check_pair_block("wave_scores", qs, rs)
    out = torch.empty((B,), dtype=torch.int32, device=qs.device)
    geo = wave_geometry(Lq, Lr, affine)
    scratch = (torch.empty((B, geo.scratch_per_pair), dtype=torch.int32,
                           device=qs.device)
               if geo.scratch_per_pair and B else None)
    fn = build.function("sw", "wave_scores",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P])
    build.launch(fn, qs.device, qs.data_ptr(), rs.data_ptr(),
                 _table(qs.device).data_ptr(), out.data_ptr(), B, Lq, Lr,
                 int(gap_open), int(gap_extend), int(bool(affine)),
                 None if scratch is None else scratch.data_ptr())
    return out


def ungapped_scores(qs: torch.Tensor, rs: torch.Tensor, *,
                    x: int) -> torch.Tensor:
    """Launch K4: qs (B, Lq), rs (B, Lr) int8 residues, contiguous on one
    CUDA device -> (B,) int32 best ungapped X-drop run scores; ``x`` is
    the drop margin (2^30 for none)."""
    B, Lq, Lr = _check_pair_block("ungapped_scores", qs, rs)
    out = torch.empty((B,), dtype=torch.int32, device=qs.device)
    fn = build.function("sw", "ungapped_scores",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _P])
    build.launch(fn, qs.device, qs.data_ptr(), rs.data_ptr(),
                 _table(qs.device, False).data_ptr(), out.data_ptr(), B, Lq,
                 Lr, int(x))
    return out


def sw_rowwave(qs: torch.Tensor, rs: torch.Tensor, *,
               gap: int) -> torch.Tensor:
    """Launch K7: qs (B, Lq), rs (B, Lr) int8 residues, contiguous on one
    CUDA device -> (B,) int32 linear-gap SW best scores (``gap`` < 0)."""
    B, Lq, Lr = _check_pair_block("sw_rowwave", qs, rs)
    if gap >= 0:
        raise ValueError("sw_rowwave takes a negative gap penalty")
    out = torch.empty((B,), dtype=torch.int32, device=qs.device)
    geo = rowwave_geometry(Lq, Lr)
    scratch = (torch.empty((B, geo.scratch_per_pair), dtype=torch.int8,
                           device=qs.device)
               if geo.scratch_per_pair and B else None)
    fn = build.function("sw", "sw_rowwave",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_long, ctypes.c_long, _P, _P])
    build.launch(fn, qs.device, qs.data_ptr(), rs.data_ptr(),
                 _table(qs.device, False).data_ptr(), out.data_ptr(), B, Lq,
                 Lr, int(gap), geo.cpt, geo.segments, geo.pairs_per_block,
                 geo.smem_bytes, geo.scratch_per_pair,
                 None if scratch is None else scratch.data_ptr())
    return out
