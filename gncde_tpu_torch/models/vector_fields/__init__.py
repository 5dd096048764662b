from .layers import ConvLayer, ConvEquivFusionLayer
from .fields import PermEquivGraphVectorField, control_terms

__all__ = [
    "ConvLayer",
    "ConvEquivFusionLayer",
    "PermEquivGraphVectorField",
    "control_terms",
]
