"""The yardstick of K6's and K2's roofline shares in the dense join: the
least time the work of a call needs on an H100, from its shapes.

A frozen copy of two branches of the repository's smoke arithmetic
(``chip_smoke.py`` ``_bounds``, ``hamming_count`` and ``hamming_dist``):

* K6 (``count_kernel``) over (Q, nw) x (R, nw): one popcount a (query,
  reference, word) at 16 a clock on each SM, beside the XOR, compare and
  add at 64 a clock (CUDA C++ Programming Guide, arithmetic instruction
  throughput of compute capability 9.0), over 132 SMs at the card's
  maximum SM clock; its bytes, each input once and the counts once, at
  the HBM rate.
* K2 (``dist_kernel``) over (Q, nw) x (R, nw): each input once and each
  distance written once at the HBM rate, against 3 operations a (query,
  reference, word) on the CUDA cores.

The H100 SXM data sheet's rates, as in ``bench/roofline.py``.
"""
from __future__ import annotations

import subprocess

from bench.roofline import CUDA_CORE_OPS_PER_S, HBM_BYTES_PER_S

SMS = 132
POPC_PER_SM_CLK = 16
INT_ALU_PER_SM_CLK = 64


def hamming_count_bound_s(Q: int, R: int, nw: int,
                          sm_clock_hz: float) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes") of one K6 call."""
    t_ops = max(Q * R * nw / POPC_PER_SM_CLK,
                Q * R * (nw + 2) / INT_ALU_PER_SM_CLK) / (SMS * sm_clock_hz)
    t_bytes = ((Q + R) * nw * 4 + Q * 4) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def hamming_dist_bound_s(Q: int, R: int, nw: int,
                         calls: int = 1) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes") of ``calls`` K2 calls
    whose query rows add up to ``Q``, each against all ``R`` references.
    The bytes and operations are summed over the calls before the larger
    is taken, which never exceeds the sum of each call's bound; the two
    agree wherever every call lies on one side of the roofline (bytes, at
    every nw up to 26)."""
    t_bytes = ((Q + calls * R) * nw * 4 + Q * R * 4) / HBM_BYTES_PER_S
    t_ops = 3 * Q * R * nw / CUDA_CORE_OPS_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sm_clock_hz() -> float | None:
    """The card's maximum SM clock from ``nvidia-smi``, or None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.split()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
