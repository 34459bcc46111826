"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427]: 26L d=2560 10H (MQA kv=1,
head_dim 256) d_ff=7680, vocab 256000. RG-LRU + local attention, 1:2 —
pattern (rglru, rglru, local_attn), window 2048, tied embeddings.

26 = 8 whole pattern repeats + 2 remainder rglru blocks (scan + unrolled
tail). n_heads=10 is not divisible by the model axis -> attention is
replicated over "model"; TP lives in the MLP (DESIGN.md §5)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab_size=256000,
        block_pattern=("rglru", "rglru", "local_attn"), window=2048,
        rnn_width=2560, conv_width=4,
        mlp_act="gelu", mlp_gated=True, norm_type="rmsnorm",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab_size=256,
        block_pattern=("rglru", "rglru", "local_attn"), window=16,
        rnn_width=64, conv_width=4,
        mlp_act="gelu", mlp_gated=True, norm_type="rmsnorm",
        tie_embeddings=True, attn_chunk=16, ce_chunk=16,
    )
