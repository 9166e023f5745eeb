"""phi4-mini-3.8b — RoPE + SwiGLU + GQA [arXiv:2412.08905; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    attention="full",
    rope="full",
    mlp="swiglu",
    norm="rmsnorm",
    source="arXiv:2412.08905",
)
