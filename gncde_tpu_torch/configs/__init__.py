from ._schema import ConfigError, Schema
from .dataset_configs import ODEDataSetCfg
from .vector_field_configs import VectorFieldCfg
from .optimiser_configs import (
    ConstantScheduleCfg,
    OptimiserCfg,
    clip_by_global_norm,
)
from .loss_configs import MSELossCfg
from .wandb_configs import WandBConfig
from .model_configs import GraphNeuralCDECfg

__all__ = [
    "ConfigError", "Schema", "ODEDataSetCfg", "VectorFieldCfg",
    "ConstantScheduleCfg", "OptimiserCfg",
    "clip_by_global_norm", "MSELossCfg", "WandBConfig", "GraphNeuralCDECfg",
]
