"""OLMoE-1B-7B [arXiv:2409.02060]: 16L d=2048 16H (GQA kv=16) d_ff=1024,
vocab 50304, MoE 64 experts top-8."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab_size=50304,
        n_experts=64, experts_per_token=8,
        mlp_act="silu", mlp_gated=True, norm_type="rmsnorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab_size=256,
        n_experts=8, experts_per_token=2,
        mlp_act="silu", mlp_gated=True, norm_type="rmsnorm",
        attn_chunk=16, ce_chunk=16,
    )
