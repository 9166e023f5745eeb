"""minitron-8b — pruned nemotron, squared-ReLU MLP, vocab 256k [arXiv:2407.14679; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    attention="full",
    rope="full",
    mlp="squared_relu",
    norm="layernorm",
    source="arXiv:2407.14679",
    notes="nemotron family: squared-ReLU MLP, 256k vocab embedding dominates",
)
