"""LM model stack: the 10 assigned architectures as one composable
decoder/encoder family (GQA/MoE/RG-LRU/xLSTM/encoder blocks) — the
port of ``repro/models``, serving and training, on one device or over a
mesh of entries (``sharding``)."""
from .config import ModelConfig
from .model import (LM, ShardedLM, chunked_ce, decode_step, forward,
                    init_cache, init_params, loss_fn, params_from_reference,
                    prefill, reference_params, train_step_fn)

__all__ = ["ModelConfig", "LM", "init_params", "forward", "loss_fn",
           "train_step_fn", "decode_step", "prefill", "init_cache",
           "chunked_ce", "params_from_reference", "reference_params",
           "ShardedLM"]
