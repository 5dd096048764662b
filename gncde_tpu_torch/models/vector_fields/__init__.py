from .layers import ConvLayer, ConvEquivFusionLayer
from .fields import PermEquivGraphVectorField, control_terms
from .wrappers import CDEWrapperVectorField

__all__ = [
    "ConvLayer",
    "ConvEquivFusionLayer",
    "PermEquivGraphVectorField",
    "control_terms",
    "CDEWrapperVectorField",
]
