"""HuBERT-XLarge [arXiv:2106.07447]: 48L d=1280 16H d_ff=5120, encoder-only
(wav2vec2-style), masked-unit prediction over 504 cluster targets.

The CNN audio frontend is a STUB (per brief): input_specs()/loss take
precomputed frame embeddings (B, S, d)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab_size=504,
        is_encoder=True, embedding_inputs=True,
        mlp_act="gelu", mlp_gated=False, norm_type="layernorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=64,
        is_encoder=True, embedding_inputs=True,
        mlp_act="gelu", mlp_gated=False, norm_type="layernorm",
        attn_chunk=16, ce_chunk=16,
    )
