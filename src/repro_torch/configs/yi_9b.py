"""Yi-9B [arXiv:2403.04652]: 48L d=4096 32H (GQA kv=4) d_ff=11008,
vocab 64000. Llama-arch."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab_size=64000,
        mlp_act="silu", mlp_gated=True, norm_type="rmsnorm",
        rope_theta=5e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab_size=256,
        mlp_act="silu", mlp_gated=True, norm_type="rmsnorm",
        rope_theta=5e6, attn_chunk=16, ce_chunk=16,
    )
