"""K1 — fused SimHash accumulation on the card (``csrc/siggen.cu``).

Replaces the TPU kernel ``repro/kernels/siggen.py::siggen_accumulate_kernel``.
The source note in ``csrc/siggen.cu`` gives the bound and the design. The
plain twin is :func:`repro_torch.kernels.ref.siggen_accumulate_ref`; the
routing wrapper is :func:`repro_torch.kernels.ops.signatures_fused`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def siggen_accumulate(rows: torch.Tensor, cb: torch.Tensor, H: torch.Tensor,
                      T: int) -> torch.Tensor:
    """Launch K1: rows (S, D) int32, cb (W, D) int8, H (W, f) int8, all
    contiguous on one CUDA device -> V (S, f) int32."""
    if rows.dtype != torch.int32 or cb.dtype != torch.int8 \
            or H.dtype != torch.int8:
        raise TypeError("siggen_accumulate takes rows int32, cb int8, H int8")
    if rows.dim() != 2 or cb.dim() != 2 or H.dim() != 2:
        raise ValueError("siggen_accumulate takes 2-D operands")
    S, D = rows.shape
    W, f = H.shape
    if cb.shape != (W, D):
        raise ValueError(f"cb {tuple(cb.shape)} does not match rows D={D} "
                         f"and H W={W}")
    if f % 32 or not 32 <= f <= 256:
        raise ValueError(f"siggen_accumulate takes f in 32..256 step 32, got {f}")
    if not (rows.is_contiguous() and cb.is_contiguous() and H.is_contiguous()):
        raise ValueError("siggen_accumulate takes contiguous operands")
    if not (rows.device == cb.device == H.device):
        raise ValueError("siggen_accumulate operands must share one device")
    out = torch.empty((S, f), dtype=torch.int32, device=rows.device)
    fn = build.function("siggen", "siggen_accumulate",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    build.launch(fn, rows.device, rows.data_ptr(), cb.data_ptr(),
                 H.data_ptr(), out.data_ptr(), S, D, W, f, int(T))
    return out
