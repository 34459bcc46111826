"""Production mesh + meta-tensor input specs for every dry-run cell: the
port of ``repro/launch/mesh.py``.

``make_production_mesh`` is a FUNCTION: importing this module touches no
device. Its entries default to ``"meta"``, the port's stand-in for the
reference's 512 placeholder host devices — the one entry point of the
port that does not default to the card, since the dry run allocates
nothing (pass ``devices`` to place a production mesh on real ones).
"""
from __future__ import annotations

import math

import torch

from ..configs import SHAPES
from ..models.sharding import Mesh, _item, make_rules


def make_production_mesh(*, multi_pod: bool = False, devices="meta"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, devices)


def dp_size(mesh) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


def batch_specs(cfg, mesh, batch: int):
    """Logical batch sharding: DP axes when they divide the batch."""
    rules = make_rules(cfg, mesh)
    b = _item(rules["batch"]) if batch % dp_size(mesh) == 0 else None
    return rules, b


def input_specs(cfg, shape_name: str, mesh) -> dict:
    """Meta-tensor stand-ins for one cell's inputs, each with its spec:
    name -> (tensor on "meta", spec tuple, or None for an unplaced
    scalar).

    train  -> inputs, targets
    prefill-> inputs (B, S) tokens or (B, S, d) bf16 embeddings
    decode -> tokens (B, 1), pos () — the cache is built separately.

    ``shape_name``: a key of ``SHAPES``, or such a dict itself (a
    smoke-sized cell).
    """
    sh = shape_name if isinstance(shape_name, dict) else SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    _, b = batch_specs(cfg, mesh, B)
    kind = sh["kind"]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind in ("train", "prefill"):
        if cfg.embedding_inputs:
            inputs = (meta((B, S, cfg.d_model), torch.bfloat16),
                      (b, None, None))
        else:
            inputs = (meta((B, S), torch.int32), (b, None))
        if kind == "prefill":
            return {"inputs": inputs}
        return {"inputs": inputs,
                "targets": (meta((B, S), torch.int32), (b, None))}
    return {"tokens": (meta((B, 1), torch.int32), (b, None)),
            "pos": (meta((), torch.int32), None)}


def chips(mesh) -> int:
    return math.prod(mesh.shape.values())
