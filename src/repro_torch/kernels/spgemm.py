"""K5 — upper-mask SpGEMM pair emission on the card (``csrc/spgemm.cu``).

Replaces the TPU kernel ``repro/kernels/spgemm.py::upper_pairs_kernel``.
The source note in ``csrc/spgemm.cu`` gives the bound and the design. The
plain twin is :func:`repro_torch.kernels.ref.upper_pairs_ref`; the routing
wrapper is :func:`repro_torch.kernels.ops.emit_upper_pairs`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def upper_pairs(offs_s: torch.Tensor, ids_s: torch.Tensor, *,
                cap: int) -> torch.Tensor:
    """Launch K5: offsets (G, U+1) and ids (G, E) int32, contiguous on one
    CUDA device -> (G, cap, 2) int32 pair buffers, -1 past each band's
    true count."""
    if offs_s.dtype != torch.int32 or ids_s.dtype != torch.int32:
        raise TypeError("upper_pairs takes int32 offsets and ids")
    if offs_s.dim() != 2 or ids_s.dim() != 2 or \
            offs_s.shape[0] != ids_s.shape[0]:
        raise ValueError(f"upper_pairs shapes {tuple(offs_s.shape)} x "
                         f"{tuple(ids_s.shape)} do not pair up")
    G, U1 = offs_s.shape
    E = ids_s.shape[1]
    if U1 < 1 or E < 1 or G > 65535 or cap < 0:
        raise ValueError(f"upper_pairs takes U+1, E >= 1, G <= 65535 and "
                         f"cap >= 0, got {G}, {U1}, {E}, {cap}")
    if not (offs_s.is_contiguous() and ids_s.is_contiguous()):
        raise ValueError("upper_pairs takes contiguous operands")
    if offs_s.device != ids_s.device:
        raise ValueError("upper_pairs operands must share one device")
    dev = ids_s.device
    out = torch.empty((G, cap, 2), dtype=torch.int32, device=dev)
    exc = torch.empty((G, E), dtype=torch.int64, device=dev)
    total = torch.empty((G,), dtype=torch.int64, device=dev)
    fn = build.function("spgemm", "upper_pairs",
                        [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong,
                         _P])
    build.launch(fn, dev, offs_s.data_ptr(), ids_s.data_ptr(),
                 exc.data_ptr(), total.data_ptr(), out.data_ptr(), G, U1, E,
                 int(cap))
    return out
