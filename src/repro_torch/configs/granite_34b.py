"""Granite-34B-Code [arXiv:2405.04324]: 88L d=6144 48H (MQA kv=1) d_ff=24576,
vocab 49152. Deepest assigned arch — the layer-scan + FSDP + grad-accum
stress case.

Non-gated GELU MLP (GPT-BigCode lineage): with a gated MLP the analytic
count lands at 47B, with 2-matrix GELU it lands at 34B — matching the
published size pins the MLP variant."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab_size=49152,
        mlp_act="gelu", mlp_gated=False, norm_type="layernorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab_size=256,
        mlp_act="gelu", mlp_gated=False, norm_type="layernorm",
        attn_chunk=16, ce_chunk=16,
    )
