"""dbrx-132b — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base; unverified]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    attention="full",
    rope="full",
    rope_theta=500_000.0,
    mlp="swiglu",
    norm="layernorm",
    num_experts=16,
    top_k=4,
    source="hf:databricks/dbrx-base",
    notes="fine-grained MoE: 16 experts, top-4 routing, GQA kv=8",
)
