"""Architecture config schema covering all 10 assigned architectures.

One dataclass, one block vocabulary:
  'attn'       global GQA attention + MLP        (dense/moe/vlm archs)
  'local_attn' sliding-window GQA + MLP          (recurrentgemma)
  'rglru'      Griffin RG-LRU recurrent block    (recurrentgemma)
  'mlstm'      xLSTM matrix-memory block         (xlstm)
  'slstm'      xLSTM scalar-memory block         (xlstm)
`block_pattern` cycles over layers: ``n_groups`` whole repeats of the
pattern, then its first ``n_remainder`` blocks (the reference scans the
repeats and unrolls the remainder; the port applies the same layers in
the same order). A copy of ``repro/models/config.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encoder | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None    # default d_model // n_heads

    # block structure
    block_pattern: tuple[str, ...] = ("attn",)
    is_encoder: bool = False       # bidirectional attention, no decode step
    window: int | None = None      # sliding window for 'local_attn'

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # MLP
    mlp_act: str = "silu"          # silu | gelu | relu2 (squared ReLU)
    mlp_gated: bool = True         # SwiGLU-style gate

    # misc
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embedding_inputs: bool = False  # vlm/audio: frontend supplies (B,S,d) embeds
    rnn_width: int | None = None    # RG-LRU recurrence width (default d_model)
    conv_width: int = 4             # temporal conv in recurrent blocks

    # numerics / training structure
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 1024          # flash chunk (queries and kv)
    ce_chunk: int = 512             # chunked cross-entropy sequence chunk
    causal_skip: bool = False       # triangular attention schedule (§Perf B)

    def __post_init__(self):
        assert self.n_heads % self.n_kv_heads == 0
        assert self.n_layers >= len(self.block_pattern)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        """Number of whole block-pattern repeats (the scan length)."""
        return self.n_layers // len(self.block_pattern)

    @property
    def n_remainder(self) -> int:
        return self.n_layers - self.n_groups * len(self.block_pattern)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced-config variant (smoke tests)."""
        return replace(self, **kw)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embeddings + blocks), for 6·N·D roofline."""
    d, hd = cfg.d_model, cfg.hd
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    counts = {"attn": 0, "local_attn": 0, "rglru": 0, "mlstm": 0, "slstm": 0}
    attn = d * (cfg.n_heads * hd) * 2 + d * (cfg.n_kv_heads * hd) * 2
    if cfg.is_moe:
        mlp = cfg.n_experts * (d * cfg.d_ff * (3 if cfg.mlp_gated else 2))
        mlp += d * cfg.n_experts  # router
    else:
        mlp = d * cfg.d_ff * (3 if cfg.mlp_gated else 2)
    counts["attn"] = attn + mlp + 2 * d
    counts["local_attn"] = counts["attn"]
    rw = cfg.rnn_width or d
    counts["rglru"] = (d * rw * 2 + rw * cfg.conv_width + rw * 2 + d * rw
                       + mlp + 2 * d)
    counts["mlstm"] = (d * (cfg.n_heads * hd) * 3 + cfg.n_heads * hd * 2
                       + d * cfg.n_heads * hd + 2 * cfg.n_heads * hd * d // d
                       + mlp + 2 * d)
    counts["slstm"] = (d * (cfg.n_heads * hd) * 4 + cfg.n_heads * hd * hd * 4
                       + mlp + 2 * d)
    for i in range(cfg.n_layers):
        total += counts[cfg.block_pattern[i % len(cfg.block_pattern)]]
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Active (per-token) params for MoE 6·N_active·D."""
    if not cfg.is_moe:
        return param_count(cfg)
    d = cfg.d_model
    full = param_count(cfg)
    moe_total = cfg.n_layers * cfg.n_experts * (
        d * cfg.d_ff * (3 if cfg.mlp_gated else 2))
    moe_active = cfg.n_layers * cfg.experts_per_token * (
        d * cfg.d_ff * (3 if cfg.mlp_gated else 2))
    return full - moe_total + moe_active
