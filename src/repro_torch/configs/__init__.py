"""Assigned architecture configs (public literature; see per-file source tags)."""

from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    all_configs,
    get_config,
    reduced,
    shape_cells,
)
