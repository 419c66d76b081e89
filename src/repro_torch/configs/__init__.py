"""Architecture configurations (counterpart of ``repro.configs``)."""
from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    get_arch,
    list_archs,
    param_count,
    reduced,
    register,
)

__all__ = [
    "SHAPES", "ArchConfig", "MLAConfig", "MoEConfig", "ShapeConfig", "SSMConfig",
    "get_arch", "list_archs", "param_count", "reduced", "register",
]
