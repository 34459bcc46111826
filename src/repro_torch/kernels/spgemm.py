"""K5 — upper-mask SpGEMM pair emission on the card (``csrc/spgemm.cu``).

Replaces the TPU kernel ``repro/kernels/spgemm.py::upper_pairs_kernel``.
The source note in ``csrc/spgemm.cu`` gives the bound and the design. The
plain twin is :func:`repro_torch.kernels.ref.upper_pairs_ref`; the routing
wrapper is :func:`repro_torch.kernels.ops.emit_upper_pairs`.

:func:`upper_pairs_by_bucket` writes the kernel's index math (the bucket
bases and the slot -> (bucket, i, j) map) in torch, where the CPU tests
hold it against the twin and the Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
SCAN_BUCKETS = 1024   # buckets a block of the kernel's scan passes


def bucket_bases(offs: torch.Tensor):
    """One band's buckets as the kernel sees them: bucket b in [0, U]
    holds entries [offs[b-1], offs[b]) (b = 0: [0, offs[0])). Returns
    (start, n, base) int64 (U+1,) — first entry, size, and first slot (the
    exclusive prefix of n(n-1)/2) — and the band's total."""
    o = offs.to(torch.int64)
    start = torch.cat([o.new_zeros(1), o[:-1]])
    n = (o - start).clamp_min(0)
    tri = n * (n - 1) // 2
    base = torch.cumsum(tri, 0) - tri
    return start, n, base, tri.sum()


def triangle_rows(t: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """For slot t of a bucket of n entries, the row i of its upper
    triangle: the largest i with F(i) = i (2n - 1 - i) / 2 <= t, from the
    closed form in float64, checked by one correction step each way. The
    discriminant (2n - 1)^2 - 8t is exact modulo 2^64 and lies in
    (0, 2^64) for any n < 2^31, so it is read as unsigned, as the kernel
    computes it."""
    m = 2 * n - 1
    disc = m * m - 8 * t
    disc = disc.double() + (disc < 0).double() * 2.0 ** 64
    i = torch.floor((m.double() - torch.sqrt(disc)) / 2).long()
    i = i - (i * (m - i) // 2 > t).long()
    return i + ((i + 1) * (m - i - 1) // 2 <= t).long()


def upper_pairs_by_bucket(offs_s: torch.Tensor, ids_s: torch.Tensor, *,
                          cap: int) -> torch.Tensor:
    """K5's index math in torch: offsets (G, U+1), ids (G, E) -> (G, cap, 2)
    int32, bucket by bucket — a slot's bucket is the last whose base is at
    most the slot, its row i from :func:`triangle_rows`, its partner j =
    i + 1 + t - F(i). The same slots as ``upper_pairs_ref``."""
    out = torch.full((offs_s.shape[0], cap, 2), -1, dtype=torch.int32,
                     device=ids_s.device)
    for g, (offs, ids) in enumerate(zip(offs_s, ids_s)):
        start, n, base, total = bucket_bases(offs)
        s = torch.arange(min(cap, int(total)), device=ids.device)
        b = torch.searchsorted(base, s, right=True) - 1
        t = s - base[b]
        nb = n[b]
        i = triangle_rows(t, nb)
        j = i + 1 + t - i * (2 * nb - 1 - i) // 2
        a, c = ids[start[b] + i], ids[start[b] + j]
        out[g, :len(s)] = torch.stack([torch.minimum(a, c),
                                       torch.maximum(a, c)], -1)
    return out


def upper_pairs(offs_s: torch.Tensor, ids_s: torch.Tensor, *,
                cap: int) -> torch.Tensor:
    """Launch K5: offsets (G, U+1) and ids (G, E) int32, contiguous on one
    CUDA device, each band's offsets a CSR over its ids (non-decreasing,
    at most E) -> (G, cap, 2) int32 pair buffers, -1 past each band's
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
    base = torch.empty((G, U1), dtype=torch.int64, device=dev)
    csum = torch.empty((G, -(-U1 // SCAN_BUCKETS)), dtype=torch.int64,
                       device=dev)
    total = torch.empty((G,), dtype=torch.int64, device=dev)
    fn = build.function("spgemm", "upper_pairs",
                        [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                         ctypes.c_longlong, _P])
    build.launch(fn, dev, offs_s.data_ptr(), ids_s.data_ptr(),
                 base.data_ptr(), csum.data_ptr(), total.data_ptr(),
                 out.data_ptr(), G, U1, E, int(cap))
    return out
