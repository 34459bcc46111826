"""K2 — dense all-pairs Hamming distance on the card (``csrc/hamming.cu``).

Replaces the TPU kernel ``repro/kernels/hamming.py::hamming_dist_kernel``.
The source note in ``csrc/hamming.cu`` gives the bound and the design. The
plain twin is :func:`repro_torch.kernels.ref.hamming_dist_ref`; the
routing wrapper is :func:`repro_torch.kernels.ops.all_pairs_hamming`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def hamming_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Launch K2: q (Q, nw), r (R, nw) int32 bit patterns, contiguous on
    one CUDA device, nw in 1..8 -> (Q, R) int32 distances."""
    if q.dtype != torch.int32 or r.dtype != torch.int32:
        raise TypeError("hamming_dist takes int32 signature words")
    if q.dim() != 2 or r.dim() != 2 or q.shape[1] != r.shape[1]:
        raise ValueError(f"hamming_dist shapes {tuple(q.shape)} x "
                         f"{tuple(r.shape)} do not match")
    nw = q.shape[1]
    if not 1 <= nw <= 8:
        raise ValueError(f"hamming_dist takes 1..8 words per signature, got {nw}")
    if not (q.is_contiguous() and r.is_contiguous()):
        raise ValueError("hamming_dist takes contiguous operands")
    if q.device != r.device:
        raise ValueError("hamming_dist operands must share one device")
    Q, R = q.shape[0], r.shape[0]
    out = torch.empty((Q, R), dtype=torch.int32, device=q.device)
    fn = build.function("hamming", "hamming_dist",
                        [_P, _P, _P, _I, _I, _I, _P])
    build.launch(fn, q.device, q.data_ptr(), r.data_ptr(), out.data_ptr(),
                 Q, R, nw)
    return out
