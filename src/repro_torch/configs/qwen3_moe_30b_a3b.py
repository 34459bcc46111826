"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H (GQA kv=4,
head_dim 128) d_ff=768/expert, vocab 151936, MoE 128 experts top-8."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab_size=151936,
        n_experts=128, experts_per_token=8,
        mlp_act="silu", mlp_gated=True, norm_type="rmsnorm",
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256,
        n_experts=8, experts_per_token=2,
        mlp_act="silu", mlp_gated=True, norm_type="rmsnorm",
        rope_theta=1e6, attn_chunk=16, ce_chunk=16,
    )
