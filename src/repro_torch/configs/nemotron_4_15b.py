"""Nemotron-4-15B [arXiv:2402.16819]: 32L d=6144 48H (GQA kv=8) d_ff=24576,
vocab 256000. Squared-ReLU MLP (no gate), LayerNorm, untied embeddings."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab_size=256000,
        mlp_act="relu2", mlp_gated=False, norm_type="layernorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=256,
        mlp_act="relu2", mlp_gated=False, norm_type="layernorm",
        attn_chunk=16, ce_chunk=16,
    )
