from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeSpec,
    get_config,
    list_archs,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeSpec",
    "get_config",
    "list_archs",
]
