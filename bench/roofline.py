"""The yardstick of the kernels' roofline shares: the H100's data-sheet
peaks and the work a kernel call needs, from its inputs.

The peaks are NVIDIA's H100 SXM data sheet (dense, at the 700 W limit);
the run logs the card's power limit beside every result. The K3 work is a
frozen copy of the repository's smoke arithmetic (``chip_smoke.py``
``_bounds``, the Smith-Waterman branch): 6 integer operations a real cell
of each pair's matrix, and each input byte read once, each score written
once. Real cells and real residues, not the padded block: the work these
inputs need.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # HBM3
CUDA_CORE_OPS_PER_S = 67e12      # fp32 / int32 lanes outside the tensor cores
INT8_TC_OPS_PER_S = 1979e12      # int8 tensor cores
BF16_TC_FLOPS = 989e12           # bf16 tensor cores
OPS_PER_CELL = {"linear": 6, "affine": 11}


def sw_wave_bound_s(q_lens: np.ndarray, r_lens: np.ndarray,
                    gap_mode: str = "linear") -> tuple[float, str]:
    """(least seconds, "operations" or "bytes") of one K3 call over pairs
    of these real lengths."""
    q = np.asarray(q_lens, np.float64)
    r = np.asarray(r_lens, np.float64)
    cells = float((q * r).sum())
    nbytes = float(q.sum() + r.sum() + 4 * q.size)
    t_ops = cells * OPS_PER_CELL[gap_mode] / CUDA_CORE_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
