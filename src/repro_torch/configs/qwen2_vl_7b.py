"""Qwen2-VL-7B [arXiv:2409.12191]: 28L d=3584 28H (GQA kv=4) d_ff=18944,
vocab 152064. M-RoPE + dynamic-resolution ViT frontend.

Frontend is a STUB (per brief): training consumes precomputed patch/text
embeddings (B, S, d). M-RoPE's three position channels coincide for the
stub/text path, so it reduces to standard RoPE (DESIGN.md §4). n_heads=28
not divisible by the model axis -> attention replicated over "model", TP in
the MLP."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064,
        embedding_inputs=True,
        mlp_act="silu", mlp_gated=True, norm_type="rmsnorm",
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b-smoke", family="vlm",
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
        d_ff=128, vocab_size=256,
        embedding_inputs=True,
        mlp_act="silu", mlp_gated=True, norm_type="rmsnorm",
        rope_theta=1e6, attn_chunk=16, ce_chunk=16,
    )
