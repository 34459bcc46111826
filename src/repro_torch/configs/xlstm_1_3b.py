"""xLSTM-1.3B [arXiv:2405.04517]: 48L d=2048 4H d_ff=0 (no MLP sublayer),
vocab 50304. mLSTM:sLSTM at 7:1 — pattern of 8 blocks, 6 scan groups.
Pure recurrent (runs long_500k with O(1) decode state)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_pattern=("mlstm",) * 7 + ("slstm",),
        mlp_act="gelu", mlp_gated=False, norm_type="layernorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab_size=256,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        mlp_act="gelu", mlp_gated=False, norm_type="layernorm",
        attn_chunk=16, ce_chunk=16,
    )
