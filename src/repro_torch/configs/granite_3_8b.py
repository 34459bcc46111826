"""Granite-3.0-8B [hf:ibm-granite]: 40L d=4096 32H (GQA kv=8) d_ff=12800,
vocab 49155 (uneven over a 16-way model axis — GSPMD pads; exercised
deliberately)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12800, vocab_size=49155,
        mlp_act="silu", mlp_gated=True, norm_type="rmsnorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=255,   # odd vocab on purpose (uneven shards)
        mlp_act="silu", mlp_gated=True, norm_type="rmsnorm",
        attn_chunk=16, ce_chunk=16,
    )
