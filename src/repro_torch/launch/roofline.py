"""Roofline terms from the dry run's walk: the port of
``repro/launch/roofline.py``, with NVIDIA H100 constants.

Card: H100 SXM5 80GB at its 700 W power limit. The rates are NVIDIA's
data-sheet figures, not measurements:
  peak bf16 compute : 989.5 TFLOP/s dense (half the data sheet's 1,979
                      TFLOP/s, which assumes 2:4 sparsity)
  HBM bandwidth     : 3.35 TB/s
  NVLink 4          : 450 GB/s a direction (900 GB/s bidirectional)

  compute term    = flops / PEAK_FLOPS
  memory term     = hbm_bytes / HBM_BW
  collective term = collective_bytes / NVLINK_BW

The figures are per device: the walk runs one mesh entry, the first
entry of the first DP row, which computes its tensor-parallel slice of
each split sublayer and the sublayers the rules keep whole over "model"
(see ``launch/dryrun.py`` and ``models/sharding.py``); ``row_entries``
records the size of its row.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass

PEAK_FLOPS = 989.5e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per-device (the walked row)
    hlo_bytes: float            # per-device HBM traffic
    collective_bytes: float     # per-device
    collectives: dict
    model_flops: float          # 6·N·D (global, analytic)
    peak_memory_bytes: float    # per-device: placed blocks + live temps
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0   # MODEL_FLOPS / (flops * chips)
    row_entries: int = 1        # the entries of the walked entry's DP row

    def finalize(self):
        self.compute_s = self.hlo_flops / PEAK_FLOPS
        self.memory_s = self.hlo_bytes / HBM_BW
        self.collective_s = self.collective_bytes / NVLINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        total_hlo = self.hlo_flops * self.chips
        self.useful_ratio = (self.model_flops / total_hlo
                             if total_hlo else 0.0)
        return self


def analyze(walk_result, mem: dict, *, arch, shape, mesh_name, chips,
            model_flops, row_entries: int = 1) -> Roofline:
    """Roofline terms from a walk (``hlo_walk.walk``) and the per-device
    memory (``mem``: argument and temp bytes)."""
    w = walk_result
    r = Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(w.flops),
        hlo_bytes=float(w.hbm_bytes),
        collective_bytes=float(w.collective_bytes),
        collectives={k: int(v) for k, v in w.collectives.items()},
        model_flops=float(model_flops),
        peak_memory_bytes=float(mem.get("argument", 0) + mem.get("output", 0)
                                + mem.get("temp", 0)),
        row_entries=row_entries,
    )
    return r.finalize()


def model_flops_for(cfg, shape_name: str, n_params_active: int,
                    seq_len: int, global_batch: int, kind: str) -> float:
    """6·N·D for train, 2·N·D for inference forward; decode D = batch tokens
    (one step). Attention FLOPs beyond 6·N·D are excluded by convention —
    the useful-ratio column then shows attention+remat overhead explicitly."""
    if kind == "train":
        return 6.0 * n_params_active * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * n_params_active * seq_len * global_batch
    return 2.0 * n_params_active * global_batch  # decode: 1 token/seq


def save_json(path, roof: Roofline, **extra):
    with open(path, "w") as f:
        json.dump({**asdict(roof), **extra}, f, indent=1)
