"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only (assignment): the EnCodec frontend is a stub; input_specs()
provides 4 parallel codebook token streams (delay pattern applied upstream).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="dense",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    attention="full",
    rope="none",  # musicgen uses learned/sinusoidal positions; we use none+learned
    mlp="gelu",
    norm="layernorm",
    num_codebooks=4,
    modality="audio-tokens",
    source="arXiv:2306.05284",
    notes="MHA (kv=24); 4 codebook embeddings summed; 4 output heads",
)
