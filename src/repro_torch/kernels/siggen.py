"""K1 — fused SimHash accumulation on the card (``csrc/siggen.cu``).

Replaces the TPU kernel ``repro/kernels/siggen.py::siggen_accumulate_kernel``.
The source note in ``csrc/siggen.cu`` gives the bound and the design. The
plain twin is :func:`repro_torch.kernels.ref.siggen_accumulate_ref`; the
routing wrapper is :func:`repro_torch.kernels.ops.signatures_fused`.

The launch geometry (:func:`siggen_geometry`) and the layout of the
codebook and hyperplanes for the int8 tensor cores (:func:`siggen_operands`,
with the word order :func:`slot_word` that lets the first product's
accumulators feed the second product as they stand) live here, where the
CPU tests reach them; ``csrc/siggen.cu`` checks the geometry it is given.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGGEN_WARPS = 4     # warps per block
SIGGEN_BW = 128      # codebook words per tile
SIGGEN_PADB = 16     # row padding (bytes) of the shared tiles
SIGGEN_DP_MAX = 128  # D up to this runs on the tensor cores
SIGGEN_F_MAX = 256   # columns of V a launch; wider f runs in slices


@dataclass(frozen=True)
class SiggenGeometry:
    dp: int              # D zero-padded to a multiple of 32 (at least 64);
                         # 0: D > SIGGEN_DP_MAX, the exact CUDA-core path
    rows_per_block: int  # 4 warps of 16 rows x (2 for f <= 64, else 1)
    words: int           # W zero-padded to the word tile
    smem_bytes: int      # dynamic shared memory per block


def siggen_slices(f: int) -> list[tuple[int, int]]:
    """The (first column, width) of each launch of K1 for f columns: slices
    of ``SIGGEN_F_MAX``, the last one narrower."""
    return [(c, min(SIGGEN_F_MAX, f - c)) for c in range(0, f, SIGGEN_F_MAX)]


def siggen_geometry(D: int, W: int, f: int) -> SiggenGeometry:
    """K1's launch geometry for rows (S, D), a (W, D) codebook and a slice
    of f <= 256 hyperplanes: the rows tile, two cb tiles and two transposed
    H tiles in shared memory, each row padded by 16 bytes."""
    bs = SIGGEN_WARPS * 16 * (2 if f <= 64 else 1)
    if D > SIGGEN_DP_MAX:
        return SiggenGeometry(dp=0, rows_per_block=bs, words=W,
                              smem_bytes=SIGGEN_WARPS * f * 4)
    dp = max(64, -(-D // 32) * 32)
    words = -(-W // SIGGEN_BW) * SIGGEN_BW
    smem = ((bs + 2 * SIGGEN_BW) * (dp + SIGGEN_PADB)
            + 2 * f * (SIGGEN_BW + SIGGEN_PADB))
    return SiggenGeometry(dp=dp, rows_per_block=bs, words=words,
                          smem_bytes=smem)


def slot_word(k):
    """The word that sits at slot k of the second product, for an integer
    array or tensor of slots (any shape). Thread (g, t) of an m16n8
    accumulator holds words 8j + 2t and 8j + 2t + 1 of n8 tile j; the
    m16n8k32 A fragment wants k slots 4t..4t+3 (tiles 0, 1) and
    16 + 4t..16 + 4t+3 (tiles 2, 3) there, so slot 32c + 16h + 4t + m of
    chunk c holds word 32c + 16h + 8(m >> 1) + 2t + (m & 1)."""
    s = k & 31
    return (k - s) + 16 * (s >> 4) + 8 * ((s & 3) >> 1) + 2 * ((s & 15) >> 2) \
        + (s & 1)


def siggen_operands(cb: torch.Tensor, H: torch.Tensor, geo: SiggenGeometry):
    """cb and H in K1's tensor-core layout: cbp (words, dp) int8, cb zero-
    padded; htp (f, words) int8, H's rows in :func:`slot_word` order,
    transposed, zero past W; and cb_l1 (1,) int32, the largest L1 norm of
    a codebook word (0 with no word)."""
    W, D = cb.shape
    f = H.shape[1]
    dev = cb.device
    cbp = torch.zeros((geo.words, geo.dp), dtype=torch.int8, device=dev)
    cbp[:W, :D] = cb
    hp = torch.zeros((geo.words, f), dtype=torch.int8, device=dev)
    hp[:W] = H
    # on the card alone (no host copy), so a CUDA graph can capture it
    htp = hp[slot_word(torch.arange(geo.words, device=dev))].T.contiguous()
    l1 = cb.to(torch.int32).abs().sum(1, dtype=torch.int32)
    cb_l1 = torch.cat([l1, l1.new_zeros(1)]).amax().reshape(1)
    return cbp, htp, cb_l1


def siggen_accumulate(rows: torch.Tensor, cb: torch.Tensor, H: torch.Tensor,
                      T: int) -> torch.Tensor:
    """Launch K1: rows (S, D) int32, cb (W, D) int8, H (W, f) int8, all
    contiguous on one CUDA device, f a multiple of 32, T >= 1 -> V (S, f)
    int32; one grid per slice of :func:`siggen_slices`."""
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
    if f % 32 or f < 32:
        raise ValueError(f"siggen_accumulate takes f a positive multiple of "
                         f"32, got {f}")
    if T < 1:
        raise ValueError("siggen_accumulate takes T >= 1 (a zero pad row or "
                         "word must score below T)")
    if not (rows.is_contiguous() and cb.is_contiguous() and H.is_contiguous()):
        raise ValueError("siggen_accumulate takes contiguous operands")
    if not (rows.device == cb.device == H.device):
        raise ValueError("siggen_accumulate operands must share one device")
    out = torch.empty((S, f), dtype=torch.int32, device=rows.device)
    fn = build.function("siggen", "siggen_accumulate",
                        [_P] * 7 + [_I] * 8 + [ctypes.c_long, _P])
    # the layout of cb and H for every slice at once: the slices' H rows
    # are row blocks of htp (f, words)
    geo = siggen_geometry(D, W, min(f, SIGGEN_F_MAX))
    cbp = htp = cb_l1 = None
    if geo.dp:
        cbp, htp, cb_l1 = siggen_operands(cb, H, geo)
    for c, fs in siggen_slices(f):
        geo = siggen_geometry(D, W, fs)
        hp = None if htp is None else htp.data_ptr() + c * geo.words
        build.launch(fn, rows.device, rows.data_ptr(), cb.data_ptr(),
                     H.data_ptr() + c, None if cbp is None else cbp.data_ptr(),
                     hp, None if cb_l1 is None else cb_l1.data_ptr(),
                     out.data_ptr() + 4 * c, S, D, W, geo.words, fs, f,
                     int(T), geo.dp, geo.smem_bytes)
    return out
