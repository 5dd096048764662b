from .layers import ConvLayer, ConvEquivFusionDirectedLayer, ConvEquivFusionLayer
from .fields import PermEquivDirGraphVectorField, PermEquivGraphVectorField, control_terms
from .wrappers import CDEWrapperVectorField

__all__ = [
    "ConvLayer",
    "ConvEquivFusionLayer",
    "ConvEquivFusionDirectedLayer",
    "PermEquivGraphVectorField",
    "PermEquivDirGraphVectorField",
    "control_terms",
    "CDEWrapperVectorField",
]
