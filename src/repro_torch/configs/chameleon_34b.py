"""chameleon-34b — early-fusion VLM over VQ image tokens [arXiv:2405.09818; unverified].

Backbone only (assignment): the modality frontend is a stub — input_specs()
provides token ids drawn from the unified text+VQ vocabulary.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    attention="full",
    rope="full",
    qk_norm=True,
    mlp="swiglu",
    norm="rmsnorm",
    modality="vlm-tokens",
    source="arXiv:2405.09818",
    notes="early fusion; qk-norm for training stability at 34B",
)
