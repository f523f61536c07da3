from .base import (
    SHAPES,
    CrossAttnConfig,
    EncoderConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ParallelismConfig,
    ShapeSpec,
    SSMConfig,
    TrainConfig,
    get_config,
    list_configs,
    reduced,
)

__all__ = [
    "SHAPES", "CrossAttnConfig", "EncoderConfig", "MLAConfig", "ModelConfig",
    "MoEConfig", "ParallelismConfig", "ShapeSpec", "SSMConfig", "TrainConfig",
    "get_config", "list_configs", "reduced",
]
