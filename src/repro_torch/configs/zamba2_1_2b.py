"""zamba2-1.2b — Mamba2 backbone + shared attention block [arXiv:2411.15242; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    attention="full",  # the *shared* block attends; mamba2 layers are attn-free
    rope="full",
    mlp="gelu",
    norm="rmsnorm",
    ssm="mamba2",
    ssm_state=64,
    ssm_expand=2,
    shared_attn_every=6,
    source="arXiv:2411.15242",
    notes="38 mamba2 blocks; one shared attn+mlp block applied every 6 layers",
)
