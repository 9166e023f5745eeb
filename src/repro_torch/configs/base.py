"""Architecture config schema + registry.

One file per assigned architecture lives next to this module; each exposes
``CONFIG``.  ``get_config(name)`` resolves by arch id (e.g. "dbrx-132b"),
``reduced(cfg)`` produces the smoke-test variant (same family, tiny dims).
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Dict, List

ARCH_IDS = [
    "dbrx-132b",
    "mixtral-8x7b",
    "chameleon-34b",
    "chatglm3-6b",
    "qwen2.5-3b",
    "minitron-8b",
    "phi4-mini-3.8b",
    "musicgen-medium",
    "rwkv6-3b",
    "zamba2-1.2b",
]

_MODULE_OF = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # -- attention ---------------------------------------------------------
    attention: str = "full"  # full | swa | none
    window: int = 0  # SWA window (mixtral: 4096)
    rope: str = "full"  # full | partial | none
    rope_frac: float = 1.0  # fraction of head_dim rotated (glm: 0.5)
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    qk_norm: bool = False  # chameleon
    # -- mlp -----------------------------------------------------------------
    mlp: str = "swiglu"  # swiglu | squared_relu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    # -- moe -----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # -- ssm -----------------------------------------------------------------
    ssm: str = ""  # rwkv6 | mamba2
    ssm_state: int = 0  # mamba2 state dim per head
    ssm_heads: int = 0
    ssm_expand: int = 2  # mamba2 inner expansion
    # -- hybrid (zamba2) ------------------------------------------------------
    shared_attn_every: int = 0  # apply the shared attention block every N layers
    # -- modality backbone stubs -----------------------------------------------
    num_codebooks: int = 0  # musicgen EnCodec streams
    modality: str = "text"  # text | audio-tokens | vlm-tokens
    # -- numerics ----------------------------------------------------------------
    dtype: str = "bfloat16"
    # attention schedule: "dense" (compute-all-blocks + mask; baseline) or
    # "sparse" (static block-visibility schedule; beyond-paper §Perf)
    attn_impl: str = "dense"
    # KV-cache storage dtype override ("" = compute dtype); "float8_e4m3fn"
    # halves decode HBM traffic (beyond-paper §Perf)
    cache_dtype: str = ""
    # pad kv heads up to TP degree when sharding (DESIGN.md §5)
    pad_kv_to_tp: bool = True
    notes: str = ""
    source: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.attention == "none"

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SWA / SSM / hybrid)"""
        return self.attention in ("swa", "none") or self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
        emb = V * d * (2 if not self.tied_embeddings else 1)
        if self.num_codebooks:
            emb = self.num_codebooks * V * d + self.num_codebooks * V * d
        per_layer = 0
        if self.ssm == "rwkv6":
            inner = d
            # time-mix: r,k,v,w,g projections + output + data-dep lora (approx)
            per_layer += 6 * d * inner + 2 * d * 64
            per_layer += 2 * d * ff  # channel-mix (relu^2, k/v)
        elif self.ssm == "mamba2":
            inner = self.ssm_expand * d
            proj_in = d * (2 * inner + 2 * self.ssm_state * self.ssm_groups + self.ssm_heads_eff)
            per_layer += proj_in + inner * d
        if self.attention in ("full", "swa"):
            att = d * H * hd + 2 * d * KV * hd + H * hd * d
            per_layer += att
        if self.num_experts:
            per_layer += self.num_experts * 3 * d * ff + d * self.num_experts
        elif self.mlp == "swiglu":
            per_layer += 3 * d * ff
        elif self.ssm != "rwkv6":
            per_layer += 2 * d * ff
        if self.family == "hybrid" and self.shared_attn_every:
            # shared block params counted once
            att = d * H * hd + 2 * d * KV * hd + H * hd * d
            shared = att + 3 * d * ff
        else:
            shared = 0
        return emb + self.num_layers * per_layer + shared

    @property
    def tied_embeddings(self) -> bool:
        return False

    @property
    def ssm_groups(self) -> int:
        return 1

    @property
    def ssm_heads_eff(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        if self.ssm == "mamba2":
            return (self.ssm_expand * self.d_model) // 64
        return max(1, self.d_model // 64)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULE_OF:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def shape_cells(cfg: ModelConfig) -> List[ShapeConfig]:
    """The shape set for this arch; ``long_500k`` only for sub-quadratic
    archs (pure full-attention archs skip it — DESIGN.md §4)."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        cells.append(SHAPES["long_500k"])
    return cells


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    kv = min(cfg.num_kv_heads, 2)
    heads = max(4, min(cfg.num_heads, 4))
    kv = min(kv, heads)
    return dataclasses.replace(
        cfg,
        num_layers=min(cfg.num_layers, 4 if not cfg.shared_attn_every else 2 * cfg.shared_attn_every),
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        window=min(cfg.window, 64) if cfg.window else 0,
        num_experts=min(cfg.num_experts, 4),
        top_k=min(cfg.top_k, 2),
        # no-drop capacity in the smoke configs so prefill/decode/forward
        # are exactly consistent (full configs keep the paper-standard 1.25)
        capacity_factor=4.0 if cfg.num_experts else cfg.capacity_factor,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_heads=4 if cfg.ssm else 0,
        pad_kv_to_tp=False,
    )
