"""rwkv6-3b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,  # wkv heads = d_model / 64
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attention="none",
    rope="none",
    mlp="squared_relu",  # rwkv channel-mix uses relu^2
    norm="layernorm",
    ssm="rwkv6",
    source="arXiv:2404.05892",
    notes="O(1) decode state: (heads, 64, 64) per layer; long_500k runs",
)
