"""LM model stack: the 10 assigned architectures as one composable
decoder/encoder family (GQA/MoE/RG-LRU/xLSTM/encoder blocks) — the
port's serving half of ``repro/models`` (training comes later)."""
from .config import ModelConfig
from .model import (LM, decode_step, forward, init_cache, init_params,
                    params_from_reference, prefill)

__all__ = ["ModelConfig", "LM", "init_params", "forward", "decode_step",
           "prefill", "init_cache", "params_from_reference"]
