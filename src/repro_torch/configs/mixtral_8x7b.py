"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention [arXiv:2401.04088; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attention="swa",
    window=4096,
    rope="full",
    rope_theta=1_000_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    num_experts=8,
    top_k=2,
    source="arXiv:2401.04088",
    notes="SWA window 4096 makes long_500k servable with a rolling KV cache",
)
