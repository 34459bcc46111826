"""K3 — wavefront Smith-Waterman best scores on the card (``csrc/sw.cu``).

Replaces the TPU kernel ``repro/kernels/sw.py::wave_scores_kernel``, linear
and affine gaps in one kernel template. The source note in ``csrc/sw.cu``
gives the bound and the design. The plain twin is
:func:`repro_torch.kernels.ref.wave_scores_ref`; the routing wrapper is
:func:`repro_torch.kernels.ops.wavefront_scores`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_LQ = 8192       # 256 threads x 32 rows per thread


@functools.lru_cache(maxsize=4)
def _table(device: torch.device) -> torch.Tensor:
    """The sentinel-baked BLOSUM62 table (21*21,) int32 on ``device``."""
    from ..align.gotoh import sentinel_table
    return torch.as_tensor(sentinel_table().reshape(-1), device=device)


def wave_scores(qs: torch.Tensor, rs: torch.Tensor, *, gap_open: int,
                gap_extend: int, affine: bool) -> torch.Tensor:
    """Launch K3: qs (B, Lq), rs (B, Lr) int8 residues, contiguous on one
    CUDA device -> (B,) int32 best local scores."""
    if qs.dtype != torch.int8 or rs.dtype != torch.int8:
        raise TypeError("wave_scores takes int8 residues")
    if qs.dim() != 2 or rs.dim() != 2 or qs.shape[0] != rs.shape[0]:
        raise ValueError(f"wave_scores shapes {tuple(qs.shape)} x "
                         f"{tuple(rs.shape)} do not pair up")
    B, Lq = qs.shape
    Lr = rs.shape[1]
    if not (1 <= Lq <= MAX_LQ and Lr >= 1):
        raise ValueError(f"wave_scores takes 1 <= Lq <= {MAX_LQ} and "
                         f"Lr >= 1, got Lq={Lq}, Lr={Lr}")
    if not (qs.is_contiguous() and rs.is_contiguous()):
        raise ValueError("wave_scores takes contiguous operands")
    if qs.device != rs.device:
        raise ValueError("wave_scores operands must share one device")
    out = torch.empty((B,), dtype=torch.int32, device=qs.device)
    fn = build.function("sw", "wave_scores",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    build.launch(fn, qs.device, qs.data_ptr(), rs.data_ptr(),
                 _table(qs.device).data_ptr(), out.data_ptr(), B, Lq, Lr,
                 int(gap_open), int(gap_extend), int(bool(affine)))
    return out
