"""Cost extraction by walking what the port dispatches: the port of
``repro/launch/hlo_walk.py``.

The reference parses XLA's optimized HLO, multiplying while-body costs by
trip counts. The port has no HLO: it runs eagerly, so :func:`walk` runs a
function under a ``TorchDispatchMode`` (on meta tensors, which allocate
nothing, or real ones) and counts every aten op as it is dispatched:

  * flops            — matmul-class ops only (``mm``, ``bmm``, ``addmm``,
                       ``baddbmm``, which ``matmul`` and ``einsum`` lower
                       to) at 2·M·N·K, ``torch.utils.flop_counter``'s
                       formulas; elementwise flops are ignored, as the
                       reference ignores them
  * hbm_bytes        — input plus output bytes of every op but views (an
                       eager op really does round-trip HBM: there is no
                       fusion to keep values on chip)
  * collective_bytes — the bytes of every move between two mesh entries
                       (``Mesh.move``; under autograd its gradient's move
                       back too, and a dry run's counted moves), by its
                       tag, under the reference's five keys
  * peak_temp_bytes  — the most bytes of op outputs alive at once: a new
                       storage is counted when an op returns it and let go
                       when it is freed (arguments the caller holds, and
                       what in-place ops write into them, are not in it)

``unknown_loops`` is always 0: Python loops dispatch op by op, so the
trip-count problem the reference solves cannot arise.
``parse_computations``, ``_trip_count`` and ``collective_bytes_from_hlo``
have no counterpart (no HLO).
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import (addmm_flop, baddbmm_flop, bmm_flop,
                                      mm_flop)

from ..models.sharding import COLLECTIVES, listen

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default: mm_flop, _aten.bmm.default: bmm_flop,
            _aten.addmm.default: addmm_flop,
            _aten.baddbmm.default: baddbmm_flop}


@dataclass
class WalkResult:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    unknown_loops: int = 0
    peak_temp_bytes: float = 0.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    def __init__(self, res: WalkResult):
        super().__init__()
        self.res = res
        self.lock = threading.Lock()
        self.live = 0
        self.seen: set = set()

    def _free(self, key, nbytes):
        with self.lock:
            self.seen.discard(key)
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        res = self.res
        if func in _MATMULS:
            res.flops += _MATMULS[func](*args, out_val=out, **kwargs)
        if func.is_view:
            return out
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        res.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        given = {id(t.untyped_storage()) for t in ins}
        for o in outs:
            st = o.untyped_storage()
            key = id(st)
            with self.lock:
                if key in self.seen or key in given:    # in place
                    continue
                self.seen.add(key)
                self.live += st.nbytes()
                res.peak_temp_bytes = max(res.peak_temp_bytes, self.live)
            weakref.finalize(st, self._free, key, st.nbytes())
        return out


def walk(fn, *args, **kwargs) -> WalkResult:
    """Run ``fn(*args, **kwargs)`` and count what it dispatches (see the
    module docstring). Returns the counts; the result of ``fn`` is
    dropped."""
    res = WalkResult()

    def on_move(kind, nbytes):
        res.collective_bytes += nbytes
        res.collectives[kind] += nbytes

    with listen(on_move), _Counter(res):
        fn(*args, **kwargs)
    return res
