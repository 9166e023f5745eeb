"""chatglm3-6b — GQA kv=2, partial (2d) RoPE, QKV bias [arXiv:2406.12793; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    attention="full",
    rope="partial",
    rope_frac=0.5,
    qkv_bias=True,
    mlp="swiglu",
    norm="rmsnorm",
    source="arXiv:2406.12793",
    notes="kv=2 << TP=16 stresses KV replication; hillclimb candidate",
)
