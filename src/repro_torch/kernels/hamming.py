"""K2 (dense all-pairs Hamming distance) and K6 (per-query count within
Hamming d) on the card, both in ``csrc/hamming.cu``.

K2 replaces the TPU kernel ``repro/kernels/hamming.py::hamming_dist_kernel``
and K6 ``hamming_count_kernel``. The source notes in ``csrc/hamming.cu``
give their bounds and designs. The plain twins are
:func:`repro_torch.kernels.ref.hamming_dist_ref` and
:func:`~repro_torch.kernels.ref.hamming_count_ref`; the routing wrappers
are :func:`repro_torch.kernels.ops.all_pairs_hamming` and
:func:`~repro_torch.kernels.ops.hamming_counts`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def _check(name: str, q: torch.Tensor, r: torch.Tensor) -> int:
    """Refuse what the kernels do not take; returns nw."""
    if q.dtype != torch.int32 or r.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 signature words")
    if q.dim() != 2 or r.dim() != 2 or q.shape[1] != r.shape[1]:
        raise ValueError(f"{name} shapes {tuple(q.shape)} x "
                         f"{tuple(r.shape)} do not match")
    nw = q.shape[1]
    if nw < 1:
        raise ValueError(f"{name} takes at least one word per signature")
    if not (q.is_contiguous() and r.is_contiguous()):
        raise ValueError(f"{name} takes contiguous operands")
    if q.device != r.device:
        raise ValueError(f"{name} operands must share one device")
    return nw


def hamming_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Launch K2: q (Q, nw), r (R, nw) int32 bit patterns, contiguous on
    one CUDA device, any nw >= 1 -> (Q, R) int32 distances."""
    nw = _check("hamming_dist", q, r)
    Q, R = q.shape[0], r.shape[0]
    out = torch.empty((Q, R), dtype=torch.int32, device=q.device)
    fn = build.function("hamming", "hamming_dist",
                        [_P, _P, _P, _I, _I, _I, _P])
    build.launch(fn, q.device, q.data_ptr(), r.data_ptr(), out.data_ptr(),
                 Q, R, nw)
    return out


def hamming_count(q: torch.Tensor, r: torch.Tensor, *, d: int) -> torch.Tensor:
    """Launch K6: q (Q, nw), r (R, nw) int32 bit patterns, contiguous on
    one CUDA device, any nw >= 1 -> (Q,) int32 counts of the refs within
    Hamming distance ``d`` of each query."""
    nw = _check("hamming_count", q, r)
    Q, R = q.shape[0], r.shape[0]
    out = torch.zeros((Q,), dtype=torch.int32, device=q.device)
    fn = build.function("hamming", "hamming_count",
                        [_P, _P, _P, _I, _I, _I, _I, _P])
    build.launch(fn, q.device, q.data_ptr(), r.data_ptr(), out.data_ptr(),
                 Q, R, nw, int(d))
    return out
