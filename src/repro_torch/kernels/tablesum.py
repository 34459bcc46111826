"""Job 1's table route on the card in one kernel, ``csrc/tablesum.cu``:
shingle word ids, the sum of per-word table rows and the packed signs (or
the per-sequence feature count), with no intermediate in device memory.

It replaces no TPU kernel: the JAX reference's table route is plain jnp.
The source notes in ``csrc/tablesum.cu`` give its bound and design. The
plain twin is :func:`repro_torch.kernels.ref.table_sums_ref`; the routing
wrapper is :func:`repro_torch.kernels.ops.table_sums`.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int

#: id of a contribution table -> (a weak reference to it, its version, its
#: largest |entry|): each table's max is read once, not at every launch
_MAX_ABS: dict[int, tuple] = {}


def accumulator_bits(largest: int, S: int) -> int:
    """The signature kernel's accumulator: 32 bits where no partial sum of
    at most ``S`` table entries of ``|value| <= largest`` can leave int32
    (``largest * S < 2^31``), else 64."""
    return 32 if largest * S < 1 << 31 else 64


def max_abs(table: torch.Tensor) -> int:
    """The table's largest |entry|: read (one sync) the first time a table
    is seen and again after it is written in place, else remembered."""
    hit = _MAX_ABS.get(id(table))
    if hit is not None and hit[0]() is table and hit[1] == table._version:
        return hit[2]
    m = max(int(table.max()), -int(table.min()))
    for key in [i for i, h in _MAX_ABS.items() if h[0]() is None]:
        del _MAX_ABS[key]
    _MAX_ABS[id(table)] = (weakref.ref(table), table._version, m)
    return m


def table_sums(ids: torch.Tensor, lengths: torch.Tensor, table: torch.Tensor,
               *, k: int) -> torch.Tensor:
    """Launch the kernel on operands the wrapper checked: ids (N, L) int8
    contiguous, lengths (N,) integer and a contiguous int32 table of
    20^k + 1 rows, all on one CUDA device. A (W + 1, f) contribution table
    gives packed signatures (N, f//32) int32, summed in int32 where
    :func:`accumulator_bits` allows it (10% faster than int64 at the read
    set and the refs on an H100), a (W + 1,) count table the counts (N,)
    int32."""
    N, L = ids.shape
    W = table.shape[0] - 1
    if lengths.dtype != torch.int32:
        # validity compares pos + k with the length, pos + k <= L
        lengths = lengths.clamp(0, L).to(torch.int32)
    lengths = lengths.contiguous()
    if table.dim() == 2:
        nw = table.shape[1] // 32
        wide = accumulator_bits(max_abs(table), max(L - k + 1, 0)) == 64
        out = torch.empty((N, nw), dtype=torch.int32, device=ids.device)
        fn = build.function("tablesum", "table_signatures",
                            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
        build.launch(fn, ids.device, ids.data_ptr(), lengths.data_ptr(),
                     table.data_ptr(), out.data_ptr(), N, L, k, W, nw,
                     int(wide))
    else:
        out = torch.empty((N,), dtype=torch.int32, device=ids.device)
        fn = build.function("tablesum", "table_counts",
                            [_P, _P, _P, _P, _I, _I, _I, _I, _P])
        build.launch(fn, ids.device, ids.data_ptr(), lengths.data_ptr(),
                     table.data_ptr(), out.data_ptr(), N, L, k, W)
    return out
