from ._schema import ConfigError, Schema
from .dataset_configs import ODEDataSetCfg, TGBDataSetCfg
from .vector_field_configs import VectorFieldCfg
from .optimiser_configs import (
    ConstantScheduleCfg,
    OptimiserCfg,
    clip_by_global_norm,
)
from .loss_configs import MSELossCfg
from .wandb_configs import WandBConfig
from .model_configs import GraphNeuralCDECfg, TGBGraphNeuralCDECfg

__all__ = [
    "ConfigError", "Schema", "ODEDataSetCfg", "TGBDataSetCfg", "VectorFieldCfg",
    "ConstantScheduleCfg", "OptimiserCfg",
    "clip_by_global_norm", "MSELossCfg", "WandBConfig", "GraphNeuralCDECfg",
    "TGBGraphNeuralCDECfg",
]
