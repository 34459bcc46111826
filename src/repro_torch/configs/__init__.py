"""Architecture registry: the 10 LM archs and the paper's own pipeline.

The port's copy of ``repro/configs``. The paper's configurations are in
``configs/scallops.py``. Each LM arch module exposes config() (exact
published shape) and smoke_config() (reduced same-family variant for CPU
tests). Select with --arch <id>.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "olmoe-1b-7b",
    "qwen3-moe-30b-a3b",
    "hubert-xlarge",
    "recurrentgemma-2b",
    "qwen2-vl-7b",
    "nemotron-4-15b",
    "granite-3-8b",
    "granite-34b",
    "yi-9b",
    "xlstm-1.3b",
]


def _module(name: str):
    return importlib.import_module(
        f"{__name__}.{name.replace('-', '_').replace('.', '_')}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()


# ---------------------------------------------------------------- shapes
# Input-shape set shared by all LM archs.
SHAPES = {
    "train_4k":    dict(kind="train",   seq_len=4_096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32_768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524_288, global_batch=1),
}

# Sub-quadratic / decode-capable skips.
SUBQUADRATIC = {"recurrentgemma-2b", "xlstm-1.3b"}
ENCODER_ONLY = {"hubert-xlarge"}


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    if arch in ENCODER_ONLY and shape in ("decode_32k", "long_500k"):
        return False, "encoder-only: no decode step"
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "long_500k needs sub-quadratic attention (brief rule)"
    return True, ""


def cells():
    """All 40 (arch, shape) cells with applicability."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            ok, why = shape_applicable(a, s)
            out.append((a, s, ok, why))
    return out
